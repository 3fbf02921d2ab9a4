// fused_simulate: a whole single-reach Preissmann simulation in one launch,
// and fused_simulate_batched: B such simulations (ensemble members) in one
// launch, one thread block per member.
//
// Replaces flowsim_tpu/ops/pallas/fused_newton.py (_kernel via _build_call /
// fused_simulate, and _kernel_batched via _build_call_batched /
// fused_simulate_batched): for each of nt-1 time levels — gate-controller update,
// previous-level state, then a while-Newton of {section state + energy slope
// per node, cell residuals and Jacobian, boundary rows, residual norm,
// 2x2-block PCR solve, update} that ends on the PRE-update residual norm
// with that iteration's update still applied.
//
// What bounds it on an H100: latency — not bytes, not flops.  A run reads a
// few KB and writes 2 * nt * N doubles (0.75 MB for the flagship, N = 121,
// nt = 385), and does a few thousand flops per node and iteration; but the
// iterations are strictly sequential (4803 for the flagship) and each one is
// a chain of barrier-separated steps: closures, stencil, reduction and
// ceil(log2 N) = 7 PCR sweeps.  One simulation cannot use more than one SM
// without paying a grid-wide barrier (microseconds) per step, so the design
// puts ONE thread block on one simulation and makes the chain short:
//
//  * one thread per node (the latency build gives each node's closures two);
//    h, Q and the linear system live in shared memory for the whole run, the
//    geometry and the previous level's state in registers; device memory is
//    touched only to read the inputs once and to write each finished level;
//  * the level loop and the Newton loop are loops inside the block, so the
//    whole simulation is one launch (no per-iteration launch or host sync);
//  * neighbour values travel through shared memory; the assembly writes the
//    block rows straight into the PCR buffer; the solve is the shared
//    pcr_common.cuh sweep, ping-ponging two buffers (an in-place sweep
//    races), one barrier per sweep;
//  * the second PCR buffer doubles as the neighbour-exchange area during
//    assembly, which keeps the footprint at 30 doubles (240 B) per node and
//    lets N <= 964 fit the 227 KB of one SM (longer reaches, up to the TPU
//    kernel's 8192 nodes, take the long build below: the same state in a
//    scratch of device memory, several nodes a thread);
//  * every thread computes the same reduced residual norm from the same
//    per-warp partial sums, so the loop condition is uniform and no thread
//    can leave a barrier behind;
//  * blockIdx.x indexes the simulation and every per-simulation array is
//    reached through it: a batch of B ensemble members is the same kernel on
//    a grid of B blocks.  Each member has its own geometry rows, initial
//    state, boundary series, parameter block (rating coefficients, pivots,
//    gate cooldown, bed levels) and gate-controller state, and runs its own
//    while-Newton, so its per-level iteration counts are those of its single
//    run and a member that diverges holds up no other.  The TPU kernel puts
//    members on vector sublanes and loops while any member is active; here
//    the hardware scheduler queues the blocks that are not resident yet.
//
// Options: lateral inflow (qlat_mode 1: per node, 2: per level and node; the
// theta-weighted cell average is formed once per level with the plain
// engine's association), store_boundaries (write nodes 0 and N-1 only,
// [S, nt, 2]), and an upstream rating curve with its own coefficient block.
//
// Lumped storage (a reservoir behind a fixed_depth boundary, at either end or
// both): the boundary row is one thread's work, so that thread runs the SAME
// 80-step bracketed bisection as ops/storage.py::mass_balance, with the
// stage-volume and stage-area tables read from device memory (two tables of
// 4096 doubles stay in L2) and the same table interpolation, operation for
// operation — the per-level Newton counts match the plain engine exactly.
// Its outflow rating may be of any kind but gated_blend (beyond the
// quadratics reach_common.cuh's rating_discharge_n, which the junctions of
// fused_network.cu call too): a
// poly_n rating's coefficients or a table rating's stages and discharges
// follow the end's tables, their length in the storage ints (us nr, ds nr).
// The TPU kernel instead inverts a monotone stage grid with a sign count and
// one-hot masks and resamples the tables to a 1024-point grid: a workaround
// for a vector unit without loops or gathers, not carried over.  The storage
// row is a separate, non-inlined device function fed from its own parameter
// block ([S, 2, SP_COUNT], upstream then downstream) by the boundary thread
// alone, and the carried reservoir stage lives in the output array
// ([S, nt, 2]: the stage of level k-1 is read back by the thread that wrote
// it), so the other threads hold no storage state in registers.
//
// Irregular sections (the TABLE builds; the table path of both TPU kernels:
// _section_df_table / _section_from_brackets, fused_newton.py:268 / :317):
// per node seven tables of M depth samples, interpolated linearly.  They stay
// in device memory in float64 and are read through L2 — 7 x 121 x 1024 x 8 B
// = 6.9 MB for one 121-node reach at M = 1024, far more than shared memory
// holds beside the solve, and each evaluation reads two rows of each table
// (14 doubles a node).  The TPU kernel instead keeps f32 tables in VMEM and
// fetches the bracket by one-hot masked windows and sublane gathers, and its
// batched form shares member 0's tables with a per-member conveyance scale;
// here an ensemble shares the four tables the geometry alone sets (A, P, T,
// dR/dA) and reads each member's own K, n_eq and dK/dA, which keeps a batched
// launch bit-identical to single launches.  The bracket index is formed as
// the plain engine forms it: a division by the grid step (not a product with
// a packed reciprocal), floored and clamped in float64.
//
// Everything is float64 (native on this card): no double-single pairs and no
// f32 Jacobian as on the TPU.  The arithmetic mirrors ops/sections.py,
// ops/hydraulics.py, ops/rating_curve.py, ops/boundary.py and
// ops/preissmann.py expression for expression (cbrt + one Newton polish and
// sqrt for the fractional powers, the same guards and clamps, centered
// rating-curve basis, central-difference dQ/dz); built with --fmad=false the
// trajectory matches the plain PyTorch engine to rounding.
//
// Builds.  One arithmetic, the same bits; choose_build_id picks by the shape,
// the geometry and the member count (table geometry: the register build, and
// the residency build past one wave of it; N > 964: the long build).  The
// register build (one thread a node, 248 registers, two blocks an SM) runs
// every shape up to 964 nodes.  At N <= 128 without
// storage a launch that one wave of the latency build holds (one block an SM:
// 132 members on an H100, so every single simulation) takes the latency
// build below: one warp a scheduler left each float64 division, sqrt and cbrt
// of a node's closures waiting out its latency, and two threads a node halve
// that chain.  A larger batch takes the register build while one wave of it
// holds the batch (264), then the residency build, __launch_bounds__(128,
// 4): 128 registers with a few hundred bytes spilled, four blocks an SM, 528
// members in flight.  Five or six blocks an SM ran no faster, and neither did
// keeping the geometry and the previous level's state in shared memory to
// spill less: at four blocks the SM's issue and shared-memory traffic, not
// latency, set the pace.
//
// Reached on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py):
// the flagship (N = 121, 4803 iterations) 45.1 ms in the latency build
// against 71.4 ms in the register build, 9.5 us per Newton iteration against
// 15.2 (the probe: closures 8.7 -> 3.5, assembly 1.7 -> 1.5, seven sweeps
// 4.2 -> 4.1); 45 us per iteration at N = 964 (the 1024-thread build, 64
// registers, spilling); 10 240 flagship members, nodes 0 and N-1 stored,
// about 2.0 s in the residency build against 2.84 s in the register build.
// With a lumped storage the boundary thread's bisection sets the pace: the
// 21-node reservoir example runs at 21 us per iteration (1.8 ms for 87).
// PERF.md keeps the readings.
//
// C interface (ctypes): launches on the given stream, allocates nothing,
// does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "pcr_common.cuh"
#include "reach_common.cuh"

namespace {

constexpr int COMP = pcr::components<1>();  // 14 components per node
constexpr int SMEM_DOUBLES_PER_NODE = 2 * COMP + 2;

// The gate controller's state, identical in every thread: its update once per
// level, before Newton, on the PREVIOUS level's downstream stage.
struct GateCtl {
    double open, cooldown = 0.0, prev_time = -1.0;
    __device__ __forceinline__ void step(const Rating& rat, int k, double dt, double stage) {
        const double time = (double)k * dt;
        const double elapsed = prev_time >= 0.0 ? time - prev_time : 0.0;
        cooldown = clamp_min(cooldown - elapsed, 0.0);
        const bool can_act = cooldown <= 0.0;
        const bool do_open = can_act && (stage >= rat.pivot + 0.5) && (open < 0.5);
        const bool do_close = can_act && (stage <= rat.pivot - 1.0) && (open > 0.5);
        open = do_open ? 1.0 : (do_close ? 0.0 : open);
        cooldown = (do_open || do_close) ? rat.cooldown : cooldown;
        prev_time = time;
    }
};

// What the cell assembly reads of a node: this iterate's closures and the
// previous level's state.
struct NodeIt { double h, Q, A, Q2A, Se, dA_dh, dSe_dA, dSe_dQ, QA; };
struct NodePrev { double h, Q, A, Se, Q2A; };

// The rows of cell (i, i+1) in the system buf (component-major, ld doubles a
// component): node i's row 1 (continuity) and node i+1's row 0 (momentum).
// dzdx = (z[i+1] - z[i]) / dx; qavg the cell's lateral inflow (qlat).
// Returns the cell's squared residuals.
__device__ __forceinline__ double cell_rows(double* buf, int ld, int i, double theta, double dt, double dx,
                                            const NodeIt& c0, const NodeIt& c1, const NodePrev& p0,
                                            const NodePrev& p1, double dzdx, bool qlat, double qavg) {
#define TDIFF(c1, c0, p1, p0) (((c1) + (c0) - (p1) - (p0)) / (2.0 * dt))
#define SDIFF(c1, c0, p1, p0) ((theta * ((c1) - (c0)) + (1.0 - theta) * ((p1) - (p0))) / dx)
#define CAVG(c1, c0, p1, p0) (0.5 * theta * ((c1) + (c0)) + 0.5 * (1.0 - theta) * ((p1) + (p0)))
    const double th_dx = theta / dx;
    const double inv2dt = 1.0 / (2.0 * dt);
    double Rc = TDIFF(c1.A, c0.A, p1.A, p0.A) + SDIFF(c1.Q, c0.Q, p1.Q, p0.Q);
    if (qlat) Rc = Rc - qavg;
    const double avgA = CAVG(c1.A, c0.A, p1.A, p0.A);
    const double dYdx = dzdx + SDIFF(c1.h, c0.h, p1.h, p0.h);
    const double avgSe = CAVG(c1.Se, c0.Se, p1.Se, p0.Se);
    const double Rm = TDIFF(c1.Q, c0.Q, p1.Q, p0.Q) + SDIFF(c1.Q2A, c0.Q2A, p1.Q2A, p0.Q2A)
        + G * avgA * (dYdx + avgSe);
    const double geom = dYdx + avgSe;

    const double dC_dh_i = c0.dA_dh * inv2dt;
    const double dC_dh_i1 = c1.dA_dh * inv2dt;
    const double dM_dh_i = (th_dx * (c0.QA * c0.QA) * c0.dA_dh
        + G * (avgA * (-th_dx + 0.5 * theta * c0.dSe_dA * c0.dA_dh)
               + 0.5 * theta * c0.dA_dh * geom));
    const double dM_dh_i1 = (-th_dx * (c1.QA * c1.QA) * c1.dA_dh
        + G * (avgA * (th_dx + 0.5 * theta * c1.dSe_dA * c1.dA_dh)
               + 0.5 * theta * c1.dA_dh * geom));
    const double dM_dQ_i = inv2dt - th_dx * 2.0 * c0.QA + G * avgA * 0.5 * theta * c0.dSe_dQ;
    const double dM_dQ_i1 = inv2dt + th_dx * 2.0 * c1.QA + G * avgA * 0.5 * theta * c1.dSe_dQ;

    const int j = i + 1;
    // node i, row 1: continuity of cell i
    buf[6 * ld + i] = dC_dh_i;   buf[7 * ld + i] = -th_dx;
    buf[10 * ld + i] = dC_dh_i1; buf[11 * ld + i] = th_dx;
    buf[13 * ld + i] = -Rc;
    // node i+1, row 0: momentum of cell i
    buf[0 * ld + j] = dM_dh_i;   buf[1 * ld + j] = dM_dQ_i;
    buf[4 * ld + j] = dM_dh_i1;  buf[5 * ld + j] = dM_dQ_i1;
    buf[12 * ld + j] = -Rm;
    return Rc * Rc + Rm * Rm;
#undef TDIFF
#undef SDIFF
#undef CAVG
}

// STORAGE selects the build with the lumped-storage rows: a run without
// storage takes the build that has no call to storage_row in it, so its
// register allocation is what it was before storage existed.  MINB is the
// number of blocks an SM must hold: the launch bound caps the registers at
// 65536 / (MINB * BLOCK), and what does not fit spills.  No build changes an
// operation, so every build gives the same bits.  PROBE: the probe build
// (reach_common.cuh, Probe) of the flagship's shape.  TABLE: the geometry
// kind, irregular sections from lookup tables (reach_common.cuh, TabGeo: the
// rows [S, TG_ROWS, N] and the tables in device memory) instead of closed-form
// trapezoids ([S, G_ROWS, N]); only the closures differ, energy_slope, the
// assembly, the boundary and storage rows and the solve are shared.
template <int BLOCK, bool STORAGE, int MINB, bool PROBE, bool TABLE>
__global__ void __launch_bounds__(BLOCK, MINB)
fused_simulate_kernel(const double* __restrict__ geo_all,   // [S, 13, N] / [S, 4, N] (TABLE)
                      const double* __restrict__ h0_all,    // [S, N]
                      const double* __restrict__ Q0_all,    // [S, N]
                      const double* __restrict__ us_all,    // [S, nt]
                      const double* __restrict__ ds_all,    // [S, nt]
                      const double* __restrict__ par_all,   // [S, P_COUNT]
                      const double* __restrict__ qlat_all,  // [S, N] / [S, nt, N] / null
                      double* __restrict__ depth_all,       // [S, nt, W], W = N or 2
                      double* __restrict__ flow_all,        // [S, nt, W]
                      int* __restrict__ iters_all,          // [S, nt]
                      double* __restrict__ err_all,         // [S, nt]
                      int* __restrict__ conv_all,           // [S, nt]
                      double* __restrict__ gate_all,        // [S, nt]
                      double* stage_all,                    // [S, nt, 2]: ds (or us-only), us; NaN-filled
                      const double* __restrict__ stor_all,  // [S, 2, SP_COUNT] / null
                      const double* __restrict__ stab_all,  // storage tables, us then ds / null
                      long long stab_stride,                // doubles per member (0: shared)
                      int n, int nt, int max_iter, int sweeps,
                      int us_kind, int ds_kind, int rc_kind, int us_rc_kind,
                      int store_boundaries, int qlat_mode,
                      int us_sflags, int ds_sflags, int us_nv, int us_na, int ds_nv, int ds_na,
                      int us_nr, int ds_nr,                   // doubles of storage rating data
                      const double* __restrict__ tab_shared,  // [TS_COUNT, N, M] (TABLE)
                      const double* __restrict__ tab_k,       // [S, N, M] (TABLE)
                      const double* __restrict__ tab_neq,     // [S, N, M] (TABLE)
                      const double* __restrict__ tab_dk,      // [S, N, M] (TABLE)
                      int tab_m,                              // M samples a table row
                      long long* __restrict__ probe_out,    // [PH_COUNT] cycles (probe build)
                      double* __restrict__ scratch_all) {   // the long build's alone
    extern __shared__ double smem[];
    __shared__ double warp_part[2][32];

    const size_t sim = blockIdx.x;
    const double* geo = geo_all + sim * (size_t)(TABLE ? (int)TG_ROWS : (int)G_ROWS) * n;
    const double* us_series = us_all + sim * (size_t)nt;
    const double* ds_series = ds_all + sim * (size_t)nt;
    const double* par = par_all + sim * (size_t)P_COUNT;
    const int width = store_boundaries ? 2 : n;   // stored nodes per level
    double* depth = depth_all + sim * (size_t)nt * width;
    double* flow = flow_all + sim * (size_t)nt * width;
    const double* qlat = qlat_mode == QLAT_NONE ? nullptr
        : qlat_all + sim * (size_t)(qlat_mode == QLAT_LEVELS ? nt : 1) * n;
    int* iters = iters_all + sim * (size_t)nt;
    double* errs = err_all + sim * (size_t)nt;
    int* conv = conv_all + sim * (size_t)nt;
    double* gate = gate_all + sim * (size_t)nt;
    double* stage = stage_all + sim * (size_t)nt * 2;
    const bool us_stor = STORAGE && (us_kind == BC_FIXED) && (us_sflags & ST_ON);
    const bool ds_stor = STORAGE && (ds_kind == BC_FIXED) && (ds_sflags & ST_ON);

    double* buf0 = smem;                   // the assembled system / PCR ping
    double* buf1 = buf0 + (size_t)COMP * n;  // neighbour exchange / PCR pong
    double* sh = buf1 + (size_t)COMP * n;    // depth per node
    double* sQ = sh + n;                     // discharge per node

    const int i = threadIdx.x;
    const bool node = i < n;
    const bool cell = i < n - 1;     // thread i owns cell (i, i+1); node N-1 has none
    const bool first = i == 0;
    const bool last = i == n - 1;

    const double theta = par[P_THETA], dt = par[P_DT], dx = par[P_DX], tol = par[P_TOL];
    Bc us_bc{par[P_US_BED_LEVEL], par[P_US_BED_SLOPE], par[P_US_INIT_DEPTH], us_kind};
    Bc ds_bc{par[P_DS_BED_LEVEL], par[P_DS_BED_SLOPE], par[P_DS_INIT_DEPTH], ds_kind};
    Rating rat{par[P_RC_LOW0], par[P_RC_LOW1], par[P_RC_LOW2],
               par[P_RC_HIGH0], par[P_RC_HIGH1], par[P_RC_HIGH2],
               par[P_RC_SHIFT], par[P_RC_PIVOT], par[P_RC_BUFFER], par[P_RC_FD],
               par[P_RC_COOLDOWN], rc_kind};
    const bool gated = (ds_kind == BC_RATING) && (rc_kind == RC_GATED);

    typename std::conditional<TABLE, TabGeo, Geo>::type g{};
    double z1 = 0.0;  // bed level of node i+1
    if (node) {
        if constexpr (TABLE) {
            const size_t nm = (size_t)n * tab_m;
            const size_t row = (size_t)i * tab_m;
            g.ts = tab_shared + row;
            g.k = tab_k + sim * nm + row;
            g.neq = tab_neq + sim * nm + row;
            g.dk = tab_dk + sim * nm + row;
            g.nm = nm;
            g.z = geo[TG_ZBED * n + i];     g.curv = geo[TG_CURV * n + i];
            g.dgrid = geo[TG_DMAX * n + i] / (double)(tab_m - 1);
            g.jmax = (double)(tab_m - 2);
        } else {
            g.z = geo[G_ZBED * n + i];      g.b = geo[G_BMAIN * n + i];
            g.m = geo[G_MMAIN * n + i];     g.n = geo[G_NMAIN * n + i];
            g.compound = geo[G_COMPOUND * n + i] != 0.0;
            g.hbank = geo[G_HBANK * n + i]; g.bl = geo[G_BFPL * n + i];
            g.br = geo[G_BFPR * n + i];     g.mfp = geo[G_MFP * n + i];
            g.nl = geo[G_NLEFT * n + i];    g.nr = geo[G_NRIGHT * n + i];
            g.s0 = geo[G_BEDSLOPE * n + i]; g.curv = geo[G_CURV * n + i];
        }
        if (cell) z1 = geo[G_ZBED * n + i + 1];
        sh[i] = h0_all[sim * (size_t)n + i];
        sQ[i] = Q0_all[sim * (size_t)n + i];
    }
#define STORE_LEVEL(k)                                                      \
    if (store_boundaries) {                                                 \
        if (first) { depth[(size_t)(k) * 2] = sh[0]; flow[(size_t)(k) * 2] = sQ[0]; }          \
        if (last) { depth[(size_t)(k) * 2 + 1] = sh[i]; flow[(size_t)(k) * 2 + 1] = sQ[i]; }   \
    } else if (node) {                                                      \
        depth[(size_t)(k) * n + i] = sh[i];                                 \
        flow[(size_t)(k) * n + i] = sQ[i];                                  \
    }
    STORE_LEVEL(0)
    GateCtl gc{par[P_GATE_INIT]};
    if (first) { iters[0] = 0; errs[0] = 0.0; conv[0] = 1; gate[0] = gc.open; }
    __syncthreads();
    Probe<PROBE> probe;
    probe.start();
    double gate_stage = ds_bc.bed_level + sh[n - 1];

    for (int k = 1; k < nt; ++k) {
        if (gated) gc.step(rat, k, dt, gate_stage);

        // -- previous-level state, own node and node i+1
        NodePrev p0{}, p1{};
        if (node) {
            p0.h = sh[i]; p0.Q = sQ[i];
            const Sec s = section_state(g, p0.h);
            const Slope e = energy_slope(g, s, p0.h, p0.Q);
            p0.A = s.A; p0.Se = e.Se; p0.Q2A = p0.Q * p0.Q / s.A;
            buf1[0 * n + i] = p0.A; buf1[1 * n + i] = p0.Se; buf1[2 * n + i] = p0.Q2A;
        }
        __syncthreads();
        probe.mark(PH_LEVEL);
        if (cell) {
            p1.h = sh[i + 1]; p1.Q = sQ[i + 1];
            p1.A = buf1[0 * n + i + 1]; p1.Se = buf1[1 * n + i + 1]; p1.Q2A = buf1[2 * n + i + 1];
        }
        const double us_target = us_series[k], ds_target = ds_series[k];
        // lateral inflow of this level: the theta-weighted cell average
        double qavg = 0.0;
        if (cell && qlat_mode != QLAT_NONE) {
            const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * n : qlat;
            const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * n : qlat;
            qavg = 0.5 * theta * (qc[i + 1] + qc[i]) + 0.5 * (1.0 - theta) * (qp[i + 1] + qp[i]);
        }
        __syncthreads();
        probe.mark(PH_PREV);

        // -- while-Newton: the condition is on the residual computed BEFORE
        //    the update, and that iteration's update is still applied
        double err = CUDART_INF;
        int it = 0;
        while (err >= tol && it < max_iter) {
            double h = 0, Q = 0;
            Sec s{};
            Slope e{};
            double QA0 = 0, Q2A0 = 0;
            if (node) {
                h = sh[i]; Q = sQ[i];
                s = section_state(g, h);
                e = energy_slope(g, s, h, Q);
                QA0 = Q / s.A; Q2A0 = Q * Q / s.A;
                buf1[0 * n + i] = s.A;      buf1[1 * n + i] = Q2A0;
                buf1[2 * n + i] = e.Se;     buf1[3 * n + i] = s.dA_dh;
                buf1[4 * n + i] = e.dSe_dA; buf1[5 * n + i] = e.dSe_dQ;
                buf1[6 * n + i] = QA0;
            }
            __syncthreads();
            probe.mark(PH_CLOSURES);

            double sq = 0.0;
            if (node) {
                // structural zeros: L row 1 and U row 0
                buf0[2 * n + i] = 0.0; buf0[3 * n + i] = 0.0;
                buf0[8 * n + i] = 0.0; buf0[9 * n + i] = 0.0;
            }
            if (cell) {
                const int j = i + 1;
                const NodeIt c0{h, Q, s.A, Q2A0, e.Se, s.dA_dh, e.dSe_dA, e.dSe_dQ, QA0};
                const NodeIt c1{sh[j], sQ[j], buf1[0 * n + j], buf1[1 * n + j], buf1[2 * n + j],
                                buf1[3 * n + j], buf1[4 * n + j], buf1[5 * n + j], buf1[6 * n + j]};
                sq = cell_rows(buf0, n, i, theta, dt, dx, c0, c1, p0, p1, (z1 - g.z) / dx,
                               qlat_mode != QLAT_NONE, qavg);
            }
            if (node && first) {  // upstream row: D row 0 of node 0
                double res, df_dh, df_dQ;
                // read here, by this one thread and only for a rating row, so
                // that the block is not held in registers by every thread
                Rating us_rat{};
                if (us_kind == BC_RATING)
                    us_rat = Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                    par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                    par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                    par[P_URC_FD], 0.0, us_rc_kind};
                buf0[0 * n + i] = 0.0;   buf0[1 * n + i] = 0.0;
                if (us_stor) {
                    // positive Q drains an upstream reservoir (sign -1); level 1
                    // anchors on the previous level's surface, later levels on
                    // the stage this thread stored for level k-1
                    const double Y_old = k == 1 ? p0.h + us_bc.bed_level : stage[(size_t)(k - 1) * 2 + 1];
                    res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT),
                                      stab_all + sim * (size_t)stab_stride, us_sflags, us_nv, us_na, us_nr,
                                      -1.0, us_bc.bed_level, dt, p0.Q, Y_old, s.A, s.R, s.n_eq, s.dR_dA,
                                      s.dA_dh, h, Q, &buf0[4 * n + i], &buf0[5 * n + i],
                                      &buf0[12 * n + i], &stage[(size_t)k * 2 + 1]);
                    // with no downstream storage the upstream stage is the run's reservoir_stage
                    if (!ds_stor) stage[(size_t)k * 2] = stage[(size_t)k * 2 + 1];
                } else {
                    boundary_row(us_bc, us_rat, s, h, Q, us_target, gc.open, res, df_dh, df_dQ);
                    buf0[4 * n + i] = df_dh; buf0[5 * n + i] = df_dQ;
                    buf0[12 * n + i] = -res;
                }
                sq += res * res;
            }
            if (node && last) {   // downstream row: D row 1 of node N-1
                double res, df_dh, df_dQ;
                buf0[10 * n + i] = 0.0;   buf0[11 * n + i] = 0.0;
                if (ds_stor) {
                    // level 1 anchors on the current trial stage (the reference
                    // model's bootstrap), later levels on the stored stage
                    const double Y_old = k == 1 ? h + ds_bc.bed_level : stage[(size_t)(k - 1) * 2];
                    res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT) + SP_COUNT,
                                      stab_all + sim * (size_t)stab_stride + 2 * (us_nv + us_na) + us_nr,
                                      ds_sflags, ds_nv, ds_na, ds_nr, 1.0, ds_bc.bed_level, dt, p0.Q, Y_old,
                                      s.A, s.R, s.n_eq, s.dR_dA, s.dA_dh, h, Q, &buf0[6 * n + i],
                                      &buf0[7 * n + i], &buf0[13 * n + i], &stage[(size_t)k * 2]);
                } else {
                    boundary_row(ds_bc, rat, s, h, Q, ds_target, gc.open, res, df_dh, df_dQ);
                    buf0[6 * n + i] = df_dh;  buf0[7 * n + i] = df_dQ;
                    buf0[13 * n + i] = -res;
                }
                sq += res * res;
            }
            // the barrier inside also publishes buf0 and retires every read
            // of the exchange area before the first sweep overwrites it
            err = sqrt(block_sum(sq, warp_part[it & 1]));
            probe.mark(PH_ASSEMBLY);

            double* src = buf0;
            double* dst = buf1;
            int stride = 1;
            for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                if (node) pcr::sweep_node<1>(src, dst, n, n, stride, i);
                __syncthreads();
                probe.mark(PH_SWEEPS);
                double* t = src; src = dst; dst = t;
            }
            if (node) {
                double delta[2];
                pcr::backsolve_node<1>(src, n, i, delta);
                sh[i] = h + delta[0];
                sQ[i] = Q + delta[1];
            }
            ++it;
            __syncthreads();
            probe.mark(PH_BACKSOLVE);   // back-substitution and update
        }

        STORE_LEVEL(k)
        gate_stage = ds_bc.bed_level + sh[n - 1];
        if (first) {
            iters[k] = it;
            errs[k] = err;
            conv[k] = err < tol ? 1 : 0;
            gate[k] = gc.open;
        }
    }
    probe.write(probe_out);
#undef STORE_LEVEL
}

// -- the latency build ---------------------------------------------------------
//
// One simulation of N <= 128 nodes without storage (kernel 1 on the flagship;
// kernel 3 while the batch fits the card in one wave).  The register build
// above runs one 128-thread block: one warp per scheduler of the SM, so each
// float64 division, sqrt or cbrt of a node's closures waits out its whole
// latency, and the division's slow-path branch keeps independent ones from
// overlapping (its closures issue 69 divisions and 14 square roots a node;
// chip_smoke.py --sass).  This build:
//
//  * closures (closures_lanes) on LANES = 2 threads of one warp a node (256
//    threads, two warps a scheduler): the four conveyances of a node (main
//    subsection, whole section, left and right floodplain: safe_div, cbrt,
//    conveyance, 3/2 power) are one slot each; after them every division or
//    square root of section_state / energy_slope that does not wait on
//    another is put in a round of four slots, and the lanes exchange the
//    results by shuffles.  Each value is the plain engine's expression on the
//    same operands, so the bits are the register build's; cbrt(R), darcy_f,
//    sqrt(f), the Froude number, 1/T and 1/A are formed once per node and
//    iteration instead of once per use, and the terms that only the
//    geometry sets (GeoL) once per launch.  Where no node of a warp is over
//    bank the floodplain slots are skipped;
//  * the assembly, the residual norm (the register build's block_sum tree
//    over the same threads, so every loop decision keeps its bits) and the
//    back-substitution on one thread a node, as in the register build;
//  * sweeps: pcr::sweep_node_carried, one thread a node, each node's inverse
//    of D formed once a sweep by its own thread and carried to the next
//    sweep (18 doubles a node a buffer) instead of inverted twice by its
//    neighbours.
//
// Measured on the card and dropped, each slower than this build (PERF.md
// keeps the times): four lanes a node (512 threads capped at 128 registers,
// spilling), one lane (the shared terms alone), a lane-split sweep (side and
// row of an elimination on separate lanes) and sweep_node without the
// carried inverse.  The previous level's state is kept per
// node in shared memory (written at the level start, read by the cell that
// needs it), which saves the register build's second level-start barrier.
constexpr int LATENCY_MAX_N = 128;
constexpr int LANES = 2;                        // closure lanes a node
enum { X_H, X_Q, X_A, X_SE, X_Q2A, X_COUNT };   // previous level, per node
constexpr int LAT_DOUBLES_PER_NODE = 2 * pcr::CARRY_COMP + 2 + X_COUNT;

// a node's geometry and the terms of section_state / energy_slope that only
// the geometry sets, each formed by its expression there
struct GeoL {
    double z, b, m, n, hbank, bl, br, nl, nr;
    double m2, sq_m, sq_fp, hb, T_bank, A_mf, P_mf, wab, mfp05, mfp2, dPm, dPfp, rc;
    bool compound, has_curv, has_curv_d;
};

__device__ __forceinline__ GeoL geo_terms(const double* __restrict__ geo, int n, int i) {
    GeoL g;
    g.z = geo[G_ZBED * n + i];      g.b = geo[G_BMAIN * n + i];
    g.m = geo[G_MMAIN * n + i];     g.n = geo[G_NMAIN * n + i];
    g.compound = geo[G_COMPOUND * n + i] != 0.0;
    g.hbank = geo[G_HBANK * n + i]; g.bl = geo[G_BFPL * n + i];
    g.br = geo[G_BFPR * n + i];
    const double mfp = geo[G_MFP * n + i], curv = geo[G_CURV * n + i];
    g.nl = geo[G_NLEFT * n + i];    g.nr = geo[G_NRIGHT * n + i];
    g.m2 = 2.0 * g.m;
    g.sq_m = sqrt(1.0 + g.m * g.m);
    g.sq_fp = sqrt(1.0 + mfp * mfp);
    g.hb = g.compound ? g.hbank : 1.0;
    g.T_bank = g.b + 2.0 * g.m * g.hb;
    g.A_mf = (g.b + g.T_bank) / 2.0 * g.hb;
    g.P_mf = g.b + 2.0 * g.hb * g.sq_m;
    g.wab = g.bl + g.T_bank + g.br;
    g.mfp05 = 0.5 * mfp;
    g.mfp2 = 2.0 * mfp;
    g.dPm = 2.0 * g.sq_m;
    g.dPfp = 2.0 * g.sq_fp;
    g.has_curv = curv != 0.0;
    g.has_curv_d = fabs(curv) > 1e-12;
    g.rc = 1.0 / (g.has_curv ? curv : 1.0);
    return g;
}

// the closures of one node: Sec and Slope's fields that kernel 1 reads, and
// Q/A, Q^2/A
struct ClosL { double A, T, K, dK_dA, Se, dSe_dA, dSe_dQ, QA, Q2A; };

// slot t's value, held by lane t % LANES of the node in v[t / LANES]
__device__ __forceinline__ double from_slot(const double* v, int t) {
    return __shfl_sync(0xffffffffu, v[t / LANES], t % LANES, LANES);
}

// op(t) for the slots t < NU, slot t on lane t % LANES; every lane of the
// node receives every result in out[0..NU).
template <int NU, class F>
__device__ __forceinline__ void slots(int q, F op, double* out) {
    constexpr int NS = 4 / LANES;
    double mine[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
        const int t = q + k * LANES;
        mine[k] = t < NU ? op(t) : 0.0;
    }
#pragma unroll
    for (int t = 0; t < NU; ++t) out[t] = from_slot(mine, t);
}

// section_state + energy_slope of one node at (h, Q), over the node's LANES
// lanes (every thread of the warp calls it).  cbrt1 = cbrt_polished(1.0),
// icbrt1 = pow_m1_3(1.0): the values at Rsafe = 1 of a dry node.
__device__ __forceinline__ ClosL closures_lanes(const GeoL& g, double h, double Q, int q,
                                                double cbrt1, double icbrt1) {
    // the section at this depth: every lane
    const double depth = clamp_min(h, 0.0);
    const bool wet = depth > 0.0;
    const bool ob = g.compound && (depth > g.hbank);
    const double d_fp = ob ? depth - g.hb : 0.0;
    const double T_s = g.b + g.m2 * depth;
    const double A_s = (g.b + g.m * depth) * depth;
    const double P_s = g.b + 2.0 * depth * g.sq_m;
    const double A_l = (g.bl + g.mfp05 * d_fp) * d_fp;
    const double P_l = g.bl + d_fp * g.sq_fp;
    const double A_r = (g.br + g.mfp05 * d_fp) * d_fp;
    const double P_r = g.br + d_fp * g.sq_fp;
    double A = ob ? g.A_mf + A_l + A_r : A_s;
    double P = ob ? g.P_mf + P_l + P_r : P_s;
    double T = ob ? g.wab + g.mfp2 * d_fp : T_s;
    if (!wet) { A = 0.0; P = 0.0; T = 0.0; }
    const double A_m = ob ? g.A_mf + g.T_bank * d_fp : A;
    const double P_m = ob ? g.P_mf : P;
    const double A_l2 = ob ? A_l : 0.0, P_l2 = ob ? P_l : 0.0;
    const double A_r2 = ob ? A_r : 0.0, P_r2 = ob ? P_r : 0.0;

    // slot t: R, cbrt(R), the conveyance and its 3/2 power of 0 the main
    // subsection, 1 the whole section (K_simple), 2 the left and 3 the right
    // floodplain.  Below bank a floodplain's values are 0; where no node of
    // the warp is over bank the lanes skip them.
    constexpr int NS = 4 / LANES;
    const bool flood = __any_sync(0xffffffffu, ob);
    double sR[NS], sc[NS], sK[NS], sp[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
        const int t = q + k * LANES;
        sR[k] = 0.0; sc[k] = 0.0; sK[k] = 0.0; sp[k] = 0.0;
        if (t < 2 || flood) {
            const double Ax = t == 0 ? A_m : t == 1 ? A : t == 2 ? A_l2 : A_r2;
            const double Px = t == 0 ? P_m : t == 1 ? P : t == 2 ? P_l2 : P_r2;
            const double nx = t == 2 ? g.nl : t == 3 ? g.nr : g.n;
            // safe_div and the guard of K as selects around one division each
            // (a division of 0 by 0 would take the slow path)
            const double R = Px > 0.0 ? Ax / (Px > 0.0 ? Px : 1.0) : 0.0;
            const double c = cbrt_polished(R);
            const double Kx = Ax * (c * c) / nx;
            const double K = (t == 1 || Px > 0.0) ? Kx : 0.0;
            sR[k] = R; sc[k] = c; sK[k] = K; sp[k] = pow_3_2(K);
        }
    }
    const double p_m = from_slot(sp, 0), p_l = from_slot(sp, 2), p_r = from_slot(sp, 3);
    const double R = from_slot(sR, 1), cR = from_slot(sc, 1);
    const double K_simple = from_slot(sK, 1);

    // divisions by A, T and Q alone: froude's V and D; dFr_dA's D = A/T and
    // 1/T (also dh_dA); dFr_dA's dV_dA and V, dFr_dQ's 1/A; dP_dA
    const bool ok = (P > 0.0) && (T > 0.0);
    const double dP_dh = ob ? g.dPfp : g.dPm;
    double d1[4], d2[4];
    slots<4>(q, [&](int t) {
        const double num = t == 0 ? Q : t == 3 ? 1.0 : A;
        const double den = t == 0 ? clamp_min(A, 1e-6) : t == 1 ? clamp_min(T, 1e-6) : T;
        return num / den;
    }, d1);
    const double V = d1[0], Dd = d1[1], D2 = d1[2], invT = d1[3];
    slots<4>(q, [&](int t) {
        const double num = t == 0 ? -Q : t == 1 ? Q : t == 2 ? 1.0 : dP_dh;
        const double den = t == 0 ? A * A : t == 3 ? (ok ? T : 1.0) : A;
        return num / den;
    }, d2);
    const double dV_dA = d2[0], V2 = d2[1], iA = d2[2], dP_dA = d2[3];

    // square roots: froude's, dFr_dA's and dFr_dQ's sqrt(G D), darcy_f's cbrt(Rsafe)^(1/2)
    const double gD = G * D2;
    const double cRs = R > 0.0 ? cR : cbrt1;
    double s1[3];
    slots<3>(q, [&](int t) { return sqrt(t == 0 ? G * clamp_min(Dd, 1e-6) : t == 1 ? gD : cRs); }, s1);
    const double sFr = s1[0], sgD = s1[1], sq_cRs = s1[2];

    // the compound conveyance: cbrt_polished(ksum) squared
    const double ksum = p_l + p_m + p_r;
    const double rk = cbrt(ksum);
    const double rk2 = rk * rk;
    const double rk3 = rk2 * rk;
    double d5[4];
    slots<4>(q, [&](int t) {
        const double num = t == 0 ? rk3 - ksum : t == 1 ? P - A * dP_dA : t == 2 ? 1.0 : V;
        const double den = t == 0 ? (ksum > 0.0 ? 3.0 * rk2 : 1.0) : t == 1 ? P * P : t == 2 ? cR : sFr;
        return num / den;
    }, d5);
    const double ck = rk - d5[0];
    const double Kc = ksum > 0.0 ? ck * ck : 0.0;
    const double dR_dA = ok ? d5[1] : 0.0;
    const double icR = d5[2], Fr = d5[3];
    const double K = g.compound ? Kc : K_simple;
    const bool Kpos = K > 0.0;
    const double Ks = Kpos ? K : 1.0;
    const double Rs = R > 0.0 ? R : 1.0;
    const double icRs = R > 0.0 ? icR : icbrt1;

    double d6[4];
    slots<4>(q, [&](int t) {
        const double num = t == 0 ? A * (cR * cR) : t == 1 ? 1.0 : t == 2 ? iA : icRs;
        const double den = t == 0 ? (Kc > 0.0 ? Kc : 1.0) : t == 3 ? Rs : sgD;
        return num / den;
    }, d6);
    const double n_eq_c = (A > 0.0 && R > 0.0 && Kc > 0.0) ? d6[0] : g.n;
    const double n_eq = g.compound ? n_eq_c : g.n;
    const double inv_sqrt = d6[1], dFrQ = d6[2], m13R = d6[3];

    // dK_dA, darcy_f's C, the friction slope and its Q-derivative
    double d7[4];
    slots<4>(q, [&](int t) {
        const double num = t == 0 ? (cR * cR) + A * (2.0 / 3.0) * icR * dR_dA
                         : t == 1 ? sq_cRs : t == 2 ? Q * fabs(Q) : 2.0 * fabs(Q);
        const double den = t < 2 ? n_eq : Ks * Ks;
        return num / den;
    }, d7);
    const double dK_dA = A > 0.0 ? d7[0] : 0.0;
    const double Cd = d7[1], FS = d7[2], dSfQ = d7[3];

    double d8[4];
    slots<4>(q, [&](int t) {
        const double num = t == 0 ? 8.0 * G : t == 1 ? dK_dA : t == 2 ? inv_sqrt : Q;
        const double den = t == 0 ? Cd * Cd : t == 1 ? Ks : t == 2 ? gD : A;
        return num / den;
    }, d8);
    const double f = d8[0], dKK = d8[1], isq_gD = d8[2], QA = d8[3];

    // the curvature slope and its derivatives
    const double sqf = sqrt(f);
    const double num = (2.86 * sqf + 2.07 * f) * h * h * Fr * Fr;
    const double den = (0.565 + sqf) * g.rc * g.rc;
    const double dnumQ = (2.86 * sqf + 2.07 * f) * h * h * 2.0 * Fr * dFrQ;
    double d9[4];
    slots<4>(q, [&](int t) {
        const double nm = t == 0 ? 2.86 : t == 1 ? 1.0 : t == 2 ? num : dnumQ;
        return nm / (t < 2 ? 2.0 * sqf : den);
    }, d9);
    const double c286 = d9[0], ihalf = d9[1], Scv = d9[2], dScQ = d9[3];
    const double dFr = -0.5 * V2 * isq_gD * G * invT + dV_dA * inv_sqrt;
    const double df_dA = (-(8.0 / 3.0) * G) * n_eq * n_eq * m13R * dR_dA;
    const double dnum = (c286 * df_dA + 2.07 * df_dA) * h * h * Fr * Fr
        + (2.86 * sqf + 2.07 * f) * (2.0 * h * invT * Fr * Fr + h * h * 2.0 * Fr * dFr);
    const double dden = ihalf * df_dA * g.rc * g.rc;
    double d10[2];
    slots<2>(q, [&](int t) {
        return (t == 0 ? dnum * den - num * dden : Q * Q) / (t == 0 ? den * den : A);
    }, d10);

    ClosL c;
    c.A = A; c.T = T; c.K = K; c.dK_dA = dK_dA; c.QA = QA; c.Q2A = d10[1];
    const double Sf = Kpos ? FS : 0.0;
    const double dSf_dA = Kpos ? -2.0 * FS * dKK : 0.0;
    const double dSf_dQ = Kpos ? dSfQ : 0.0;
    const double Sc = g.has_curv ? Scv : 0.0;
    const double dSc_dA = g.has_curv_d ? d10[0] * T : 0.0;
    const double dSc_dQ = g.has_curv_d ? dScQ : 0.0;
    c.Se = Sf + Sc;
    c.dSe_dA = dSf_dA + dSc_dA;
    c.dSe_dQ = dSf_dQ + dSc_dQ;
    return c;
}

// The latency build: the register build's signature (the storage and table
// arguments are not read: a run with storage or tables never takes it);
// LANES * np threads, np = 32 ceil(N / 32) nodes.  The closures run on
// LANES lanes a node (node threadIdx.x / LANES; a padding node computes as
// node N-1 and stores nothing); the assembly, the residual norm, the sweeps
// (sweep_node_carried) and the back-substitution on one thread a node (node
// threadIdx.x < np), as in the register build.
template <bool PROBE>
__global__ void __launch_bounds__(LANES * LATENCY_MAX_N, 1)
fused_latency_kernel(const double* __restrict__ geo_all, const double* __restrict__ h0_all,
                     const double* __restrict__ Q0_all, const double* __restrict__ us_all,
                     const double* __restrict__ ds_all, const double* __restrict__ par_all,
                     const double* __restrict__ qlat_all, double* __restrict__ depth_all,
                     double* __restrict__ flow_all, int* __restrict__ iters_all, double* __restrict__ err_all,
                     int* __restrict__ conv_all, double* __restrict__ gate_all, double* stage_all,
                     const double* __restrict__ stor_all, const double* __restrict__ stab_all,
                     long long stab_stride, int n, int nt, int max_iter, int sweeps,
                     int us_kind, int ds_kind, int rc_kind, int us_rc_kind,
                     int store_boundaries, int qlat_mode,
                     int us_sflags, int ds_sflags, int us_nv, int us_na, int ds_nv, int ds_na,
                     int us_nr, int ds_nr,
                     const double* __restrict__ tab_shared, const double* __restrict__ tab_k,
                     const double* __restrict__ tab_neq, const double* __restrict__ tab_dk, int tab_m,
                     long long* __restrict__ probe_out, double* __restrict__ scratch_all) {
    extern __shared__ double smem[];
    __shared__ double warp_part[2][32];

    const size_t sim = blockIdx.x;
    const double* geo = geo_all + sim * (size_t)G_ROWS * n;
    const double* us_series = us_all + sim * (size_t)nt;
    const double* ds_series = ds_all + sim * (size_t)nt;
    const double* par = par_all + sim * (size_t)P_COUNT;
    const int width = store_boundaries ? 2 : n;
    double* depth = depth_all + sim * (size_t)nt * width;
    double* flow = flow_all + sim * (size_t)nt * width;
    const double* qlat = qlat_mode == QLAT_NONE ? nullptr
        : qlat_all + sim * (size_t)(qlat_mode == QLAT_LEVELS ? nt : 1) * n;
    int* iters = iters_all + sim * (size_t)nt;
    double* errs = err_all + sim * (size_t)nt;
    int* conv = conv_all + sim * (size_t)nt;
    double* gate = gate_all + sim * (size_t)nt;

    const int np = blockDim.x / LANES;   // nodes with padding: the register build's threads
    double* buf0 = smem;                                  // the assembled system / sweep ping
    double* buf1 = buf0 + (size_t)pcr::CARRY_COMP * np;   // closures of every node / sweep pong
    double* sh = buf1 + (size_t)pcr::CARRY_COMP * np;     // depth per node
    double* sQ = sh + np;                                 // discharge per node
    double* prev = sQ + np;                               // previous level [X_COUNT][np]

    // the closures' node (LANES lanes each)
    const int ci = threadIdx.x / LANES, q = threadIdx.x % LANES;
    const int cc = ci < n ? ci : n - 1;
    const bool clead = ci < n && q == 0;   // the lane that stores the node's closures
    // the node of the assembly, the norm, the sweeps and the update
    const int i = threadIdx.x;
    const bool rows = i < np;              // whole warps
    const bool node = i < n;
    const bool cell = i < n - 1;
    const bool first = i == 0;
    const bool last = i == n - 1;

    const double theta = par[P_THETA], dt = par[P_DT], dx = par[P_DX], tol = par[P_TOL];
    Bc us_bc{par[P_US_BED_LEVEL], par[P_US_BED_SLOPE], par[P_US_INIT_DEPTH], us_kind};
    Bc ds_bc{par[P_DS_BED_LEVEL], par[P_DS_BED_SLOPE], par[P_DS_INIT_DEPTH], ds_kind};
    Rating rat{par[P_RC_LOW0], par[P_RC_LOW1], par[P_RC_LOW2],
               par[P_RC_HIGH0], par[P_RC_HIGH1], par[P_RC_HIGH2],
               par[P_RC_SHIFT], par[P_RC_PIVOT], par[P_RC_BUFFER], par[P_RC_FD],
               par[P_RC_COOLDOWN], rc_kind};
    const bool gated = (ds_kind == BC_RATING) && (rc_kind == RC_GATED);

    const GeoL g = geo_terms(geo, n, cc);
    const double gz = cell ? (geo[G_ZBED * n + i + 1] - geo[G_ZBED * n + i]) / dx : 0.0;
    const double cbrt1 = cbrt_polished(1.0);
    const double icbrt1 = 1.0 / cbrt1;

    // padding nodes: D = inv(D) = I and zeros in both buffers
    for (int t = threadIdx.x; t < np; t += blockDim.x) {
        for (int c = 0; c < pcr::CARRY_COMP; ++c) {
            const double v = (c == 4 || c == 7 || c == pcr::INV_COMP || c == pcr::INV_COMP + 3) ? 1.0 : 0.0;
            buf0[c * np + t] = v;
            buf1[c * np + t] = v;
        }
        sh[t] = t < n ? h0_all[sim * (size_t)n + t] : 0.0;
        sQ[t] = t < n ? Q0_all[sim * (size_t)n + t] : 0.0;
    }
#define STORE_LEVEL(k)                                                      \
    if (store_boundaries) {                                                 \
        if (first) { depth[(size_t)(k) * 2] = sh[0]; flow[(size_t)(k) * 2] = sQ[0]; }          \
        if (last) { depth[(size_t)(k) * 2 + 1] = sh[i]; flow[(size_t)(k) * 2 + 1] = sQ[i]; }   \
    } else if (node) {                                                      \
        depth[(size_t)(k) * n + i] = sh[i];                                 \
        flow[(size_t)(k) * n + i] = sQ[i];                                  \
    }
    __syncthreads();
    STORE_LEVEL(0)
    GateCtl gc{par[P_GATE_INIT]};
    if (first) { iters[0] = 0; errs[0] = 0.0; conv[0] = 1; gate[0] = gc.open; }
    Probe<PROBE> probe;
    probe.start();
    double gate_stage = ds_bc.bed_level + sh[n - 1];
    const int nw = np / 32;   // the register build's warps: its residual norm's partial sums

    for (int k = 1; k < nt; ++k) {
        if (gated) gc.step(rat, k, dt, gate_stage);

        // -- previous-level state of every node
        {
            const double hp = sh[cc], Qp = sQ[cc];
            const ClosL cp = closures_lanes(g, hp, Qp, q, cbrt1, icbrt1);
            if (clead) {
                prev[X_H * np + ci] = hp;    prev[X_Q * np + ci] = Qp;
                prev[X_A * np + ci] = cp.A;  prev[X_SE * np + ci] = cp.Se;
                prev[X_Q2A * np + ci] = cp.Q2A;
            }
        }
        const double us_target = us_series[k], ds_target = ds_series[k];
        double qavg = 0.0;
        if (cell && qlat_mode != QLAT_NONE) {
            const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * n : qlat;
            const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * n : qlat;
            qavg = 0.5 * theta * (qc[i + 1] + qc[i]) + 0.5 * (1.0 - theta) * (qp[i + 1] + qp[i]);
        }
        __syncthreads();
        probe.mark(PH_LEVEL);

        double err = CUDART_INF;
        int it = 0;
        while (err >= tol && it < max_iter) {
            {
                const ClosL c = closures_lanes(g, sh[cc], sQ[cc], q, cbrt1, icbrt1);
                if (clead) {
                    buf1[0 * np + ci] = c.A;      buf1[1 * np + ci] = c.Q2A;
                    buf1[2 * np + ci] = c.Se;     buf1[3 * np + ci] = c.T;
                    buf1[4 * np + ci] = c.dSe_dA; buf1[5 * np + ci] = c.dSe_dQ;
                    buf1[6 * np + ci] = c.QA;     buf1[7 * np + ci] = c.K;
                    buf1[8 * np + ci] = c.dK_dA;
                }
            }
            __syncthreads();
            probe.mark(PH_CLOSURES);

            // the register build's assembly, one thread a node, its own
            // closures read back from the exchange area
            double sq = 0.0;
            double h = 0.0, Q = 0.0;
            if (node) {
                h = sh[i]; Q = sQ[i];
                buf0[2 * np + i] = 0.0; buf0[3 * np + i] = 0.0;
                buf0[8 * np + i] = 0.0; buf0[9 * np + i] = 0.0;
            }
            if (cell) {
                const int j = i + 1;
                auto it_of = [&](int m) {
                    return NodeIt{sh[m], sQ[m], buf1[0 * np + m], buf1[1 * np + m], buf1[2 * np + m],
                                  buf1[3 * np + m], buf1[4 * np + m], buf1[5 * np + m], buf1[6 * np + m]};
                };
                auto prev_of = [&](int m) {
                    return NodePrev{prev[X_H * np + m], prev[X_Q * np + m], prev[X_A * np + m],
                                    prev[X_SE * np + m], prev[X_Q2A * np + m]};
                };
                sq = cell_rows(buf0, np, i, theta, dt, dx, it_of(i), it_of(j), prev_of(i), prev_of(j), gz,
                               qlat_mode != QLAT_NONE, qavg);
            }
            if (first || last) {   // the boundary rows read the node's conveyance
                Sec s{};
                s.A = buf1[0 * np + i]; s.T = buf1[3 * np + i]; s.dA_dh = s.T;
                s.K = buf1[7 * np + i]; s.dK_dA = buf1[8 * np + i];
                double res, df_dh, df_dQ;
                if (first) {  // upstream row: D row 0 of node 0
                    Rating us_rat{};
                    if (us_kind == BC_RATING)
                        us_rat = Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                        par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                        par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                        par[P_URC_FD], 0.0, us_rc_kind};
                    buf0[0 * np + i] = 0.0;   buf0[1 * np + i] = 0.0;
                    boundary_row(us_bc, us_rat, s, h, Q, us_target, gc.open, res, df_dh, df_dQ);
                    buf0[4 * np + i] = df_dh; buf0[5 * np + i] = df_dQ;
                    buf0[12 * np + i] = -res;
                    sq += res * res;
                }
                if (last) {   // downstream row: D row 1 of node N-1
                    buf0[10 * np + i] = 0.0;   buf0[11 * np + i] = 0.0;
                    boundary_row(ds_bc, rat, s, h, Q, ds_target, gc.open, res, df_dh, df_dQ);
                    buf0[6 * np + i] = df_dh;  buf0[7 * np + i] = df_dQ;
                    buf0[13 * np + i] = -res;
                    sq += res * res;
                }
            }
            // block_sum's tree and per-warp partials over the register
            // build's threads; the total is read after a later barrier
            if (rows) {
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
                if ((i & 31) == 0) warp_part[it & 1][i >> 5] = sq;
            }
            // publishes buf0 and retires every read of the exchange area
            // before the first sweep overwrites it
            __syncthreads();
            probe.mark(PH_ASSEMBLY);

            double* src = buf0;
            double* dst = buf1;
            int stride = 1;
            for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                if (node) {
                    if (sw == 0) pcr::sweep_node_carried<false>(src, dst, np, n, stride, i);
                    else pcr::sweep_node_carried<true>(src, dst, np, n, stride, i);
                }
                __syncthreads();
                probe.mark(PH_SWEEPS);
                double* t = src; src = dst; dst = t;
            }
            if (node) {
                double delta[2];
                pcr::backsolve_carried(src, np, i, delta);
                sh[i] = h + delta[0];
                sQ[i] = Q + delta[1];
            }
            __syncthreads();
            probe.mark(PH_BACKSOLVE);   // back-substitution and update
            double total = 0.0;
            for (int w = 0; w < nw; ++w) total += warp_part[it & 1][w];
            err = sqrt(total);
            ++it;
        }

        STORE_LEVEL(k)
        gate_stage = ds_bc.bed_level + sh[n - 1];
        if (first) {
            iters[k] = it;
            errs[k] = err;
            conv[k] = err < tol ? 1 : 0;
            gate[k] = gc.open;
        }
    }
    probe.write(probe_out);
#undef STORE_LEVEL
}

// -- the long build -------------------------------------------------------------
//
// Reaches of REGISTER_MAX_N < N <= LONG_MAX_N nodes (the TPU kernel's
// MAX_VMEM_N), and any N when a caller forces it.  The register build keeps
// 240 B a node in shared memory with one thread a node, so it stops at 964
// nodes; this build keeps the same per-node state in a scratch of device
// memory that the wrapper allocates (torch.empty), LONG_DOUBLES_PER_NODE
// doubles a node a simulation: the two PCR buffers, h and Q as in the
// register build, and the previous level's state and the cell's lateral
// inflow, which the register build holds in registers (a thread here owns
// up to eight nodes).  2.4 MB at N = 8192: it stays in the card's 50 MB L2.
//
//  * one block of LONG_BLOCK = 1024 threads a simulation; thread t owns the
//    nodes t, t + 1024, ... and runs each phase over them in that order;
//  * each node's operations are the register build's, in its order: the
//    closures of node i from its geometry rows (read from device memory at
//    each use, as the register build reads them once), the cell rows and the
//    boundary rows (the boundary node's section state formed again from the
//    same depth: the same bits), the residual norm (a thread's nodes summed
//    in order, then block_sum), the PCR sweeps (pcr::sweep_nodes) and the
//    back-substitution, the phases separated by __syncthreads() (which makes
//    a thread's writes to device memory visible to the block) as there;
//  * so at N <= 1024, one node a thread, a forced launch gives the register
//    build's bits: a thread's sum over its one node is that node's value and
//    the per-warp partials of the warps without nodes are zeros.
//
// What bounds it: the chain of an iteration, as for the register build, now
// with L2 latency on every exchange and ceil(log2 N) sweeps of up to eight
// nodes a thread; 64 registers a thread at 1024 threads, the rest spilled.
// A thread-block cluster sharing distributed shared memory, or TMA staging
// of the sweeps, would take the buffers out of L2: not done here.
constexpr int REGISTER_MAX_N = 964;     // 240 B a node in 227 KB
constexpr int LONG_MAX_N = 8192;
constexpr int LONG_BLOCK = 1024;
// per node, beside the buffers and h, Q: the previous level's state and the
// theta-weighted lateral inflow of the cell (i, i+1), [L_COUNT][N]
enum { L_H, L_Q, L_A, L_SE, L_Q2A, L_QAVG, L_COUNT };
constexpr int LONG_DOUBLES_PER_NODE = 2 * COMP + 2 + L_COUNT;

// node i's geometry as the register build loads it
template <bool TABLE>
__device__ __forceinline__ typename std::conditional<TABLE, TabGeo, Geo>::type
node_geo(const double* __restrict__ geo, int n, int i, size_t sim, const double* __restrict__ tab_shared,
         const double* __restrict__ tab_k, const double* __restrict__ tab_neq, const double* __restrict__ tab_dk,
         int tab_m) {
    typename std::conditional<TABLE, TabGeo, Geo>::type g{};
    if constexpr (TABLE) {
        const size_t nm = (size_t)n * tab_m;
        const size_t row = (size_t)i * tab_m;
        g.ts = tab_shared + row;
        g.k = tab_k + sim * nm + row;
        g.neq = tab_neq + sim * nm + row;
        g.dk = tab_dk + sim * nm + row;
        g.nm = nm;
        g.z = geo[TG_ZBED * n + i];     g.curv = geo[TG_CURV * n + i];
        g.dgrid = geo[TG_DMAX * n + i] / (double)(tab_m - 1);
        g.jmax = (double)(tab_m - 2);
    } else {
        g.z = geo[G_ZBED * n + i];      g.b = geo[G_BMAIN * n + i];
        g.m = geo[G_MMAIN * n + i];     g.n = geo[G_NMAIN * n + i];
        g.compound = geo[G_COMPOUND * n + i] != 0.0;
        g.hbank = geo[G_HBANK * n + i]; g.bl = geo[G_BFPL * n + i];
        g.br = geo[G_BFPR * n + i];     g.mfp = geo[G_MFP * n + i];
        g.nl = geo[G_NLEFT * n + i];    g.nr = geo[G_NRIGHT * n + i];
        g.s0 = geo[G_BEDSLOPE * n + i]; g.curv = geo[G_CURV * n + i];
    }
    return g;
}

// The long build: the register build's signature; scratch_all [S,
// LONG_DOUBLES_PER_NODE, N] is its per-simulation state.  STORAGE and TABLE
// as in the register build; no probe build.
template <bool STORAGE, bool TABLE>
__global__ void __launch_bounds__(LONG_BLOCK, 1)
fused_long_kernel(const double* __restrict__ geo_all, const double* __restrict__ h0_all,
                  const double* __restrict__ Q0_all, const double* __restrict__ us_all,
                  const double* __restrict__ ds_all, const double* __restrict__ par_all,
                  const double* __restrict__ qlat_all, double* __restrict__ depth_all,
                  double* __restrict__ flow_all, int* __restrict__ iters_all, double* __restrict__ err_all,
                  int* __restrict__ conv_all, double* __restrict__ gate_all, double* stage_all,
                  const double* __restrict__ stor_all, const double* __restrict__ stab_all,
                  long long stab_stride, int n, int nt, int max_iter, int sweeps,
                  int us_kind, int ds_kind, int rc_kind, int us_rc_kind,
                  int store_boundaries, int qlat_mode,
                  int us_sflags, int ds_sflags, int us_nv, int us_na, int ds_nv, int ds_na,
                  int us_nr, int ds_nr,
                  const double* __restrict__ tab_shared, const double* __restrict__ tab_k,
                  const double* __restrict__ tab_neq, const double* __restrict__ tab_dk, int tab_m,
                  long long* __restrict__ probe_out, double* scratch_all) {
    __shared__ double warp_part[2][32];

    const size_t sim = blockIdx.x;
    const double* geo = geo_all + sim * (size_t)(TABLE ? (int)TG_ROWS : (int)G_ROWS) * n;
    const double* us_series = us_all + sim * (size_t)nt;
    const double* ds_series = ds_all + sim * (size_t)nt;
    const double* par = par_all + sim * (size_t)P_COUNT;
    const int width = store_boundaries ? 2 : n;
    double* depth = depth_all + sim * (size_t)nt * width;
    double* flow = flow_all + sim * (size_t)nt * width;
    const double* qlat = qlat_mode == QLAT_NONE ? nullptr
        : qlat_all + sim * (size_t)(qlat_mode == QLAT_LEVELS ? nt : 1) * n;
    int* iters = iters_all + sim * (size_t)nt;
    double* errs = err_all + sim * (size_t)nt;
    int* conv = conv_all + sim * (size_t)nt;
    double* gate = gate_all + sim * (size_t)nt;
    double* stage = stage_all + sim * (size_t)nt * 2;
    const bool us_stor = STORAGE && (us_kind == BC_FIXED) && (us_sflags & ST_ON);
    const bool ds_stor = STORAGE && (ds_kind == BC_FIXED) && (ds_sflags & ST_ON);

    double* buf0 = scratch_all + sim * (size_t)LONG_DOUBLES_PER_NODE * n;  // the system / PCR ping
    double* buf1 = buf0 + (size_t)COMP * n;   // neighbour exchange / PCR pong
    double* sh = buf1 + (size_t)COMP * n;     // depth per node
    double* sQ = sh + n;                      // discharge per node
    double* prev = sQ + n;                    // [L_COUNT][N]

    const int t0 = threadIdx.x;
    const double theta = par[P_THETA], dt = par[P_DT], dx = par[P_DX], tol = par[P_TOL];
    Bc us_bc{par[P_US_BED_LEVEL], par[P_US_BED_SLOPE], par[P_US_INIT_DEPTH], us_kind};
    Bc ds_bc{par[P_DS_BED_LEVEL], par[P_DS_BED_SLOPE], par[P_DS_INIT_DEPTH], ds_kind};
    Rating rat{par[P_RC_LOW0], par[P_RC_LOW1], par[P_RC_LOW2],
               par[P_RC_HIGH0], par[P_RC_HIGH1], par[P_RC_HIGH2],
               par[P_RC_SHIFT], par[P_RC_PIVOT], par[P_RC_BUFFER], par[P_RC_FD],
               par[P_RC_COOLDOWN], rc_kind};
    const bool gated = (ds_kind == BC_RATING) && (rc_kind == RC_GATED);
    auto geo_of = [&](int i) { return node_geo<TABLE>(geo, n, i, sim, tab_shared, tab_k, tab_neq, tab_dk, tab_m); };

    for (int i = t0; i < n; i += LONG_BLOCK) {
        sh[i] = h0_all[sim * (size_t)n + i];
        sQ[i] = Q0_all[sim * (size_t)n + i];
    }
#define STORE_LEVEL(k)                                                                     \
    for (int i = t0; i < n; i += LONG_BLOCK) {                                             \
        if (store_boundaries) {                                                            \
            if (i == 0) { depth[(size_t)(k) * 2] = sh[0]; flow[(size_t)(k) * 2] = sQ[0]; }  \
            if (i == n - 1) { depth[(size_t)(k) * 2 + 1] = sh[i]; flow[(size_t)(k) * 2 + 1] = sQ[i]; } \
        } else {                                                                           \
            depth[(size_t)(k) * n + i] = sh[i];                                            \
            flow[(size_t)(k) * n + i] = sQ[i];                                             \
        }                                                                                  \
    }
    STORE_LEVEL(0)
    GateCtl gc{par[P_GATE_INIT]};
    if (t0 == 0) { iters[0] = 0; errs[0] = 0.0; conv[0] = 1; gate[0] = gc.open; }
    __syncthreads();
    double gate_stage = ds_bc.bed_level + sh[n - 1];

    for (int k = 1; k < nt; ++k) {
        if (gated) gc.step(rat, k, dt, gate_stage);

        // -- previous-level state and the cell's lateral inflow, per node
        for (int i = t0; i < n; i += LONG_BLOCK) {
            const auto g = geo_of(i);
            const double hp = sh[i], Qp = sQ[i];
            const Sec s = section_state(g, hp);
            const Slope e = energy_slope(g, s, hp, Qp);
            prev[L_H * n + i] = hp;   prev[L_Q * n + i] = Qp;
            prev[L_A * n + i] = s.A;  prev[L_SE * n + i] = e.Se;
            prev[L_Q2A * n + i] = Qp * Qp / s.A;
            if (i < n - 1 && qlat_mode != QLAT_NONE) {
                const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * n : qlat;
                const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * n : qlat;
                prev[L_QAVG * n + i] = 0.5 * theta * (qc[i + 1] + qc[i]) + 0.5 * (1.0 - theta) * (qp[i + 1] + qp[i]);
            }
        }
        const double us_target = us_series[k], ds_target = ds_series[k];
        __syncthreads();

        double err = CUDART_INF;
        int it = 0;
        while (err >= tol && it < max_iter) {
            for (int i = t0; i < n; i += LONG_BLOCK) {
                const auto g = geo_of(i);
                const double h = sh[i], Q = sQ[i];
                const Sec s = section_state(g, h);
                const Slope e = energy_slope(g, s, h, Q);
                buf1[0 * n + i] = s.A;      buf1[1 * n + i] = Q * Q / s.A;
                buf1[2 * n + i] = e.Se;     buf1[3 * n + i] = s.dA_dh;
                buf1[4 * n + i] = e.dSe_dA; buf1[5 * n + i] = e.dSe_dQ;
                buf1[6 * n + i] = Q / s.A;
            }
            __syncthreads();

            double sq = 0.0;
            for (int i = t0; i < n; i += LONG_BLOCK) {
                const double h = sh[i], Q = sQ[i];
                double sq_i = 0.0;
                buf0[2 * n + i] = 0.0; buf0[3 * n + i] = 0.0;
                buf0[8 * n + i] = 0.0; buf0[9 * n + i] = 0.0;
                auto prev_of = [&](int m) {
                    return NodePrev{prev[L_H * n + m], prev[L_Q * n + m], prev[L_A * n + m], prev[L_SE * n + m],
                                    prev[L_Q2A * n + m]};
                };
                if (i < n - 1) {
                    const int j = i + 1;
                    auto it_of = [&](int m, double hm, double Qm) {
                        return NodeIt{hm, Qm, buf1[0 * n + m], buf1[1 * n + m], buf1[2 * n + m],
                                      buf1[3 * n + m], buf1[4 * n + m], buf1[5 * n + m], buf1[6 * n + m]};
                    };
                    sq_i = cell_rows(buf0, n, i, theta, dt, dx, it_of(i, h, Q), it_of(j, sh[j], sQ[j]), prev_of(i),
                                     prev_of(j), (geo[G_ZBED * n + j] - geo[G_ZBED * n + i]) / dx,
                                     qlat_mode != QLAT_NONE, prev[L_QAVG * n + i]);
                }
                if (i == 0 || i == n - 1) {
                    // the boundary node's section at this iterate, formed again
                    const Sec s = section_state(geo_of(i), h);
                    const double hp = prev[L_H * n + i], Qp = prev[L_Q * n + i];
                    double res, df_dh, df_dQ;
                    if (i == 0) {   // upstream row: D row 0 of node 0
                        Rating us_rat{};
                        if (us_kind == BC_RATING)
                            us_rat = Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                            par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                            par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                            par[P_URC_FD], 0.0, us_rc_kind};
                        buf0[0 * n + i] = 0.0;   buf0[1 * n + i] = 0.0;
                        if (us_stor) {
                            const double Y_old = k == 1 ? hp + us_bc.bed_level : stage[(size_t)(k - 1) * 2 + 1];
                            res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT),
                                              stab_all + sim * (size_t)stab_stride, us_sflags, us_nv, us_na, us_nr,
                                              -1.0, us_bc.bed_level, dt, Qp, Y_old, s.A, s.R, s.n_eq, s.dR_dA,
                                              s.dA_dh, h, Q, &buf0[4 * n + i], &buf0[5 * n + i],
                                              &buf0[12 * n + i], &stage[(size_t)k * 2 + 1]);
                            if (!ds_stor) stage[(size_t)k * 2] = stage[(size_t)k * 2 + 1];
                        } else {
                            boundary_row(us_bc, us_rat, s, h, Q, us_target, gc.open, res, df_dh, df_dQ);
                            buf0[4 * n + i] = df_dh; buf0[5 * n + i] = df_dQ;
                            buf0[12 * n + i] = -res;
                        }
                        sq_i += res * res;
                    }
                    if (i == n - 1) {   // downstream row: D row 1 of node N-1
                        buf0[10 * n + i] = 0.0;   buf0[11 * n + i] = 0.0;
                        if (ds_stor) {
                            const double Y_old = k == 1 ? h + ds_bc.bed_level : stage[(size_t)(k - 1) * 2];
                            res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT) + SP_COUNT,
                                              stab_all + sim * (size_t)stab_stride + 2 * (us_nv + us_na) + us_nr,
                                              ds_sflags, ds_nv, ds_na, ds_nr, 1.0, ds_bc.bed_level, dt, Qp, Y_old,
                                              s.A, s.R, s.n_eq, s.dR_dA, s.dA_dh, h, Q, &buf0[6 * n + i],
                                              &buf0[7 * n + i], &buf0[13 * n + i], &stage[(size_t)k * 2]);
                        } else {
                            boundary_row(ds_bc, rat, s, h, Q, ds_target, gc.open, res, df_dh, df_dQ);
                            buf0[6 * n + i] = df_dh;  buf0[7 * n + i] = df_dQ;
                            buf0[13 * n + i] = -res;
                        }
                        sq_i += res * res;
                    }
                }
                sq += sq_i;
            }
            // the barrier inside publishes buf0 and retires every read of the
            // exchange area before the first sweep overwrites it
            err = sqrt(block_sum(sq, warp_part[it & 1]));

            double* src = buf0;
            double* dst = buf1;
            int stride = 1;
            for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                pcr::sweep_nodes<1>(src, dst, n, n, stride, t0, LONG_BLOCK);
                __syncthreads();
                double* t = src; src = dst; dst = t;
            }
            for (int i = t0; i < n; i += LONG_BLOCK) {
                double delta[2];
                pcr::backsolve_node<1>(src, n, i, delta);
                sh[i] = sh[i] + delta[0];
                sQ[i] = sQ[i] + delta[1];
            }
            ++it;
            __syncthreads();
        }

        STORE_LEVEL(k)
        gate_stage = ds_bc.bed_level + sh[n - 1];
        if (t0 == 0) {
            iters[k] = it;
            errs[k] = err;
            conv[k] = err < tol ? 1 : 0;
            gate[k] = gc.open;
        }
    }
#undef STORE_LEVEL
}

// Every build has one signature: a build is a kernel pointer, its block and
// its dynamic shared memory.
using KernelFn = decltype(&fused_simulate_kernel<128, false, 1, false, false>);
struct Build { KernelFn fn; int threads; size_t smem; };

// REGISTER_BUILD: N <= REGISTER_MAX_N; RESIDENCY_BUILD: N <= 128 without
// storage; LATENCY_BUILD: N <= 128 without storage, trapezoid geometry;
// LONG_BUILD: every N up to LONG_MAX_N, with a scratch in device memory.
enum { REGISTER_BUILD = 0, RESIDENCY_BUILD = 1, LATENCY_BUILD = 2, LONG_BUILD = 3 };

int threads_for(int n) { return ((n + 31) / 32) * 32; }
size_t smem_for(int n) { return (size_t)SMEM_DOUBLES_PER_NODE * n * sizeof(double); }

template <int BLOCK, bool TABLE>
KernelFn register_build(bool storage) {
    return storage ? &fused_simulate_kernel<BLOCK, true, 1, false, TABLE>
                   : &fused_simulate_kernel<BLOCK, false, 1, false, TABLE>;
}

template <bool TABLE>
KernelFn register_build_for(int n, bool storage) {
    if (n <= 128) return register_build<128, TABLE>(storage);
    if (n <= 256) return register_build<256, TABLE>(storage);
    if (n <= 512) return register_build<512, TABLE>(storage);
    return register_build<1024, TABLE>(storage);
}

KernelFn long_build(bool storage, bool table) {
    if (table) return storage ? &fused_long_kernel<true, true> : &fused_long_kernel<false, true>;
    return storage ? &fused_long_kernel<true, false> : &fused_long_kernel<false, false>;
}

// REGISTER_BUILD: the block size alone is the launch bound, so a small reach
// gets the full register budget (250 registers at N <= 128: two blocks an SM)
// and only a long one is squeezed to 64.  RESIDENCY_BUILD: four blocks an SM,
// 128 registers, the rest spilled.  A probe build exists for N <= 128 without
// storage, of the register and the latency builds, trapezoid geometry.  Table
// geometry (table) has the register and the residency builds: the latency
// build's closures are the trapezoid's own.  LONG_BUILD: 1024 threads, no
// dynamic shared memory, every shape, no probe build.
int pick_build(int n, bool storage, bool table, int build, bool probe, Build* out) {
    if (build == LONG_BUILD) {
        if (probe) return (int)cudaErrorInvalidValue;
        *out = Build{long_build(storage, table), LONG_BLOCK, 0};
        return 0;
    }
    if (n > REGISTER_MAX_N) return (int)cudaErrorInvalidValue;
    const bool small = n <= LATENCY_MAX_N && !storage;
    if (build == LATENCY_BUILD) {
        if (!small || table) return (int)cudaErrorInvalidValue;
        const int np = threads_for(n);
        *out = Build{probe ? &fused_latency_kernel<true> : &fused_latency_kernel<false>, LANES * np,
                     (size_t)LAT_DOUBLES_PER_NODE * np * sizeof(double)};
        return 0;
    }
    if (probe && (!small || build != REGISTER_BUILD || table)) return (int)cudaErrorInvalidValue;
    out->threads = threads_for(n);
    out->smem = smem_for(n);
    if (build == RESIDENCY_BUILD) {
        if (!small) return (int)cudaErrorInvalidValue;
        out->fn = table ? &fused_simulate_kernel<128, false, 4, false, true>
                        : &fused_simulate_kernel<128, false, 4, false, false>;
        return 0;
    }
    if (build != REGISTER_BUILD) return (int)cudaErrorInvalidValue;
    if (probe) out->fn = &fused_simulate_kernel<128, false, 1, true, false>;
    else out->fn = table ? register_build_for<true>(n, storage) : register_build_for<false>(n, storage);
    return 0;
}

// blocks of this build the occupancy calculator puts on one SM
int resident_blocks(const Build& b, int* blocks) {
    cudaError_t e = cudaFuncSetAttribute((const void*)b.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)b.smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, (const void*)b.fn, b.threads, b.smem);
}

// The build a launch of n_sims simulations takes (fused_newton.chosen_build
// asks it through flowsim_fused_chosen_build): at N > REGISTER_MAX_N the long
// build; at N <= 128 without storage the latency build while the batch fits
// the card in one wave of it, then the register build while it fits in one
// wave of that, then the residency build where it holds more members; every
// other shape the register build.  Table geometry skips the latency build:
// the register build, then the residency build.
int choose_build_id(int n_sims, int n, bool storage, bool table, int* build) {
    *build = REGISTER_BUILD;
    if (n > REGISTER_MAX_N) { *build = LONG_BUILD; return 0; }
    if (n > LATENCY_MAX_N || storage) return 0;
    int dev, sms, lat_bps, reg_bps, res_bps, rc;
    Build b;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
    if (!table) {
        if ((rc = pick_build(n, false, false, LATENCY_BUILD, false, &b)) || (rc = resident_blocks(b, &lat_bps)))
            return rc;
        if (n_sims <= lat_bps * sms) { *build = LATENCY_BUILD; return 0; }
    }
    if ((rc = pick_build(n, false, table, REGISTER_BUILD, false, &b)) || (rc = resident_blocks(b, &reg_bps)))
        return rc;
    if (n_sims <= reg_bps * sms) return 0;
    if ((rc = pick_build(n, false, table, RESIDENCY_BUILD, false, &b)) || (rc = resident_blocks(b, &res_bps)))
        return rc;
    if (res_bps > reg_bps) *build = RESIDENCY_BUILD;
    return 0;
}

}  // namespace

extern "C" int flowsim_fused_param_count() { return P_COUNT; }
extern "C" int flowsim_fused_probe_phases() { return PH_COUNT; }
extern "C" int flowsim_fused_smem_bytes_per_node() { return SMEM_DOUBLES_PER_NODE * (int)sizeof(double); }
extern "C" int flowsim_fused_storage_param_count() { return SP_COUNT; }
extern "C" int flowsim_fused_latency_max_n() { return LATENCY_MAX_N; }
extern "C" int flowsim_fused_register_max_n() { return REGISTER_MAX_N; }
extern "C" int flowsim_fused_long_max_n() { return LONG_MAX_N; }
extern "C" int flowsim_fused_long_scratch_bytes_per_node() { return LONG_DOUBLES_PER_NODE * (int)sizeof(double); }

#define FLOWSIM_SIM_PARAMS const void* geo, const void* h0, const void* Q0, const void* us, const void* ds, \
        const void* par, const void* qlat, void* depth, void* flow, void* iters, void* err, void* conv, \
        void* gate, void* stage, const void* stor, const void* stab, long long stab_stride, int n_sims, int n, \
        int nt, int max_iter, int us_kind, int ds_kind, int rc_kind, int us_rc_kind, int store_boundaries, \
        int qlat_mode, const int* st, const void* tab_shared, const void* tab_k, const void* tab_neq, \
        const void* tab_dk, int tab_m, void* scratch
#define FLOWSIM_SIM_ARGS geo, h0, Q0, us, ds, par, qlat, depth, flow, iters, err, conv, gate, stage, stor, stab, \
        stab_stride, n_sims, n, nt, max_iter, us_kind, ds_kind, rc_kind, us_rc_kind, store_boundaries, qlat_mode, st, \
        tab_shared, tab_k, tab_neq, tab_dk, tab_m, scratch

namespace {

int check_args(int n_sims, int n, int nt, int qlat_mode, const void* qlat, const int* st, const void* stage,
               const void* stor, const void* stab, const void* tab_shared, const void* tab_k,
               const void* tab_neq, const void* tab_dk, int tab_m) {
    if (n_sims <= 0 || n <= 1 || n > LONG_MAX_N || nt <= 0) return (int)cudaErrorInvalidValue;
    if (tab_m == 1 || tab_m < 0
        || (tab_m && (tab_shared == nullptr || tab_k == nullptr || tab_neq == nullptr || tab_dk == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (qlat_mode < QLAT_NONE || qlat_mode > QLAT_LEVELS) return (int)cudaErrorInvalidValue;
    if ((qlat_mode != QLAT_NONE) != (qlat != nullptr)) return (int)cudaErrorInvalidValue;
    if (st == nullptr || stage == nullptr) return (int)cudaErrorInvalidValue;
    if (((st[0] | st[1]) & ST_ON) && stor == nullptr) return (int)cudaErrorInvalidValue;
    if ((((st[0] | st[1]) & ST_AREA_CURVE) || st[6] || st[7]) && stab == nullptr) return (int)cudaErrorInvalidValue;
    return 0;
}

// build -1: choose_build_id; else that build (a test hook).  The long build
// needs the scratch [n_sims, LONG_DOUBLES_PER_NODE, N].
int launch(int build, bool probe, long long* probe_out, FLOWSIM_SIM_PARAMS, void* stream) {
    int rc = check_args(n_sims, n, nt, qlat_mode, qlat, st, stage, stor, stab, tab_shared, tab_k, tab_neq, tab_dk,
                        tab_m);
    if (rc) return rc;
    const bool storage = (st[0] | st[1]) & ST_ON;
    const bool table = tab_m != 0;
    if (build < 0 && (rc = choose_build_id(n_sims, n, storage, table, &build))) return rc;
    if (build == LONG_BUILD && scratch == nullptr) return (int)cudaErrorInvalidValue;
    Build b;
    if ((rc = pick_build(n, storage, table, build, probe, &b))) return rc;
    cudaError_t e = cudaFuncSetAttribute((const void*)b.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)b.smem);
    if (e != cudaSuccess) return (int)e;
    b.fn<<<n_sims, b.threads, b.smem, (cudaStream_t)stream>>>(
        (const double*)geo, (const double*)h0, (const double*)Q0, (const double*)us,
        (const double*)ds, (const double*)par, (const double*)qlat, (double*)depth, (double*)flow,
        (int*)iters, (double*)err, (int*)conv, (double*)gate, (double*)stage, (const double*)stor,
        (const double*)stab, stab_stride, n, nt, max_iter, pcr::n_sweeps(n), us_kind, ds_kind,
        rc_kind, us_rc_kind, store_boundaries, qlat_mode, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        (const double*)tab_shared, (const double*)tab_k, (const double*)tab_neq, (const double*)tab_dk, tab_m,
        probe_out, (double*)scratch);
    return (int)cudaGetLastError();
}

}  // namespace

// One block per simulation: n_sims = 1 is fused_simulate, n_sims = B is
// fused_simulate_batched.  Every array carries a leading n_sims axis (the
// storage tables only when stab_stride != 0).  st: the eight storage ints
// {us flags, ds flags, us nv, us na, ds nv, ds na, us nr, ds nr} (nr: the
// doubles of a poly_n or table outflow rating after the end's tables); stage
// [n_sims, nt, 2] is filled with NaN by the caller.  tab_m: 0 for trapezoid
// geometry (geo [n_sims, 13, N]); M for table geometry (geo [n_sims, 4, N]:
// bed level, table span, bed slope, curvature), with tab_shared [4, N, M]
// (A, P, T, dR/dA) and tab_k, tab_neq, tab_dk [n_sims, N, M] (K, n_eq,
// dK/dA).  scratch: [n_sims, LONG_DOUBLES_PER_NODE, N] doubles for the long
// build (null otherwise).  build: -1 chooses by the shape, the geometry and
// the member count (choose_build_id: what the wrappers do); 0-3 forces a
// build, so that chip_smoke.py can time the builds against each other and
// hold the long build to the register build's bits.
extern "C" int flowsim_fused_simulate(FLOWSIM_SIM_PARAMS, int build, void* stream) {
    return launch(build, false, nullptr, FLOWSIM_SIM_ARGS, stream);
}

// The probe build of the register or the latency build (build -1: the one the
// C entry chooses) at N <= 128 without storage: the same launch, and the
// cycles of each phase of thread 0 of block 0 summed over the run into probe
// [PH_COUNT] (device memory); clock_khz receives the SM clock rate the cycles
// count at.
extern "C" int flowsim_fused_simulate_probe(FLOWSIM_SIM_PARAMS, int build, void* probe, int* clock_khz,
                                            void* stream) {
    if (probe == nullptr || clock_khz == nullptr) return (int)cudaErrorInvalidValue;
    int dev, rc;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, dev))) return rc;
    return launch(build, true, (long long*)probe, FLOWSIM_SIM_ARGS, stream);
}
#undef FLOWSIM_SIM_PARAMS
#undef FLOWSIM_SIM_ARGS

// Resident blocks per SM of a build at N nodes (table != 0: of the table
// geometry's build), from the CUDA occupancy calculator.
extern "C" int flowsim_fused_resident_blocks(int n, int storage, int table, int build, int* blocks) {
    if (n <= 1 || n > LONG_MAX_N || blocks == nullptr) return (int)cudaErrorInvalidValue;
    Build b;
    const int rc = pick_build(n, storage != 0, table != 0, build, false, &b);
    return rc ? rc : resident_blocks(b, blocks);
}

// The build the C entry takes for n_sims simulations of N nodes.
extern "C" int flowsim_fused_chosen_build(int n_sims, int n, int storage, int table, int* build) {
    if (n_sims <= 0 || n <= 1 || n > LONG_MAX_N || build == nullptr) return (int)cudaErrorInvalidValue;
    return choose_build_id(n_sims, n, storage != 0, table != 0, build);
}
