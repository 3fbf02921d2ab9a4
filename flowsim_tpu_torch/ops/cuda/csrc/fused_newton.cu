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
//    kernel's 8192 nodes, take the reach build below: the state spread over
//    the shared memory of a thread-block cluster, since one simulation has
//    the whole card);
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
// the geometry and the member count (table geometry at N <= 128 without
// storage: the lean build while one wave of it holds the batch, then the
// register build, then the bracket build; N > 964: the reach build for one
// simulation, the cluster build for a batch; the long build, which kept a
// reach on one SM with its state in device memory, only forced).  The
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
// 10 240 members of the 121-node table reach at M = 96: 101.8 ms in the
// bracket build against 134.3 ms in the residency build; 1024 members of
// the 2048-node reach: 47.5 ms in the cluster build against 70.7 ms in the
// long build (58.0 with its grid capped to the L2).  One reach of 965-8192
// nodes in the reach build: the flagship refined to 50 m (N = 2409, 5506
// iterations) about 173 ms against 964 ms in the long build and 323 ms in
// the cluster build forced.  PERF.md keeps the readings.
//
// C interface (ctypes): launches on the given stream, allocates nothing,
// does not synchronise, returns cudaGetLastError().
#include <cooperative_groups.h>
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
// Returns the cell's squared residuals.  ROW_AT (the cluster build): node
// i+1's row goes to bj, its component 0 wherever it lies (another rank's
// shared memory at a rank's last node), component c at bj[c * ld].
template <bool ROW_AT = false>
__device__ __forceinline__ double cell_rows(double* buf, int ld, int i, double theta, double dt, double dx,
                                            const NodeIt& c0, const NodeIt& c1, const NodePrev& p0,
                                            const NodePrev& p1, double dzdx, bool qlat, double qavg,
                                            double* bj = nullptr) {
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
    if constexpr (ROW_AT) {
        bj[0 * ld] = dM_dh_i;   bj[1 * ld] = dM_dQ_i;
        bj[4 * ld] = dM_dh_i1;  bj[5 * ld] = dM_dQ_i1;
        bj[12 * ld] = -Rm;
    } else {
        buf[0 * ld + j] = dM_dh_i;   buf[1 * ld + j] = dM_dQ_i;
        buf[4 * ld + j] = dM_dh_i1;  buf[5 * ld + j] = dM_dQ_i1;
        buf[12 * ld + j] = -Rm;
    }
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
                      double* __restrict__ scratch_all,     // the long build's alone
                      int n_sims) {                          // the cluster build's alone
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
// Q/A, Q^2/A (R, n_eq and dR_dA: what a storage row reads of the section, in
// the reach build)
struct ClosL { double A, T, K, dK_dA, Se, dSe_dA, dSe_dQ, QA, Q2A, R, n_eq, dR_dA; };

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
    c.R = R; c.n_eq = n_eq; c.dR_dA = dR_dA;
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
                     long long* __restrict__ probe_out, double* __restrict__ scratch_all, int n_sims) {
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

// -- the bracket build ------------------------------------------------------------
//
// Kernel 3's table path on a batch past one wave of the register build (the
// TPU kernel's _section_df_table_rows, fused_newton.py:341, inside
// _kernel_batched): N <= 128 nodes of lookup tables, no storage, one thread a
// node, four blocks an SM.  Its LEAN form (below) is kernel 1's table path
// (_section_df_table / _section_from_brackets, fused_newton.py:268 / :317).
// The residency build it replaces re-read the two bracket rows of all seven
// tables (14 scattered doubles a node, three of the tables per member) from
// L2 at every evaluation, inverted each partner's D twice a sweep and held
// the previous level's state in registers, spilling at 128.  This build:
//
//  * keeps each node's bracket index and its 14 bracket values in shared
//    memory (section_state_cached), re-read from device memory only when the
//    index moves — within a level it rarely does; the values and the
//    lo + frac * (hi - lo) expression are section_state's, so are the bits;
//  * sweeps with the carried inverse (18 components a buffer), as kernel 1's
//    latency build, each node's own rows held by its thread in registers
//    from sweep to sweep (pcr::sweep_node_at_carried): at four blocks an SM
//    the sweeps are bound by shared-memory traffic, 30 % less that way;
//  * keeps the previous level's state per node in shared memory, written at
//    the level start and read by the cells, and the closures' results in the
//    exchange area for the assembly and the boundary rows (no Sec held across
//    a barrier): one level-start barrier, not two, and fewer live registers.
//
// 57 doubles and an int a node: 55.7 KB at N = 121, so four blocks fit an
// SM's 228 KB.  The residual norm is block_sum over the same threads, so
// every loop decision and every field has the residency build's bits.
//
// The lean build (LEAN): kernel 1's table path on one surveyed reach, and
// table batches that one wave of it holds.  The register build it replaces
// there read the 14 bracket values of a node through L2 at every closure
// pass, ran a previous-level closure pass and two barriers at every level
// start, and inverted each partner's D twice a sweep; the bracket build
// fixed the first and the last but, bound to four blocks an SM (128
// registers, spilling), was slower on one launch.  The lean build is the
// bracket build under the latency build's launch bound (one block an SM
// guaranteed, up to 255 registers) with no previous-level pass: a level's
// previous-level h, Q, A, Se and Q^2/A are those of its first Newton
// iteration (the same state: the gate update moves no h or Q), which that
// iteration's closures (own node) and cells (node i+1) keep in registers.
// So a level starts without a closure pass or a barrier, and there is no
// previous-level array: 52 doubles and an int a node, 50.8 KB at N = 121.
// The same operations on the same values, so the register build's bits.
constexpr int BRACKET_BLOCK = 128;
constexpr int BRACKET_MINB = 4;
constexpr int BRACKET_DOUBLES_PER_NODE = 2 * pcr::CARRY_COMP + 2 + X_COUNT + BK_COUNT;
constexpr int LEAN_DOUBLES_PER_NODE = 2 * pcr::CARRY_COMP + 2 + BK_COUNT;

// The bracket build: the register build's signature (storage arguments not
// read: a run with storage never takes it); 32 ceil(N / 32) threads, node
// threadIdx.x.  PROBE: its probe build (the previous level's barrier is
// PH_PREV; PH_LEVEL reads 0; the lean build has neither, its level start
// is in the closures of the level's first iteration).  LEAN: the lean build.
template <bool PROBE, bool LEAN = false>
__global__ void __launch_bounds__(BRACKET_BLOCK, LEAN ? 1 : BRACKET_MINB)
fused_bracket_kernel(const double* __restrict__ geo_all, const double* __restrict__ h0_all,
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
                     long long* __restrict__ probe_out, double* __restrict__ scratch_all, int n_sims) {
    extern __shared__ double smem[];
    __shared__ double warp_part[2][32];

    const size_t sim = blockIdx.x;
    const double* geo = geo_all + sim * (size_t)TG_ROWS * n;
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

    double* buf0 = smem;                                 // the assembled system / sweep ping
    double* buf1 = buf0 + (size_t)pcr::CARRY_COMP * n;   // closures of every node / sweep pong
    double* sh = buf1 + (size_t)pcr::CARRY_COMP * n;     // depth per node
    double* sQ = sh + n;                                 // discharge per node
    double* prev = sQ + n;                               // previous level [X_COUNT][N] (not LEAN)
    double* cache = prev + (size_t)(LEAN ? 0 : X_COUNT) * n;   // brackets [BK_COUNT][N]
    int* cidx = (int*)(cache + (size_t)BK_COUNT * n);    // bracket index per node

    const int i = threadIdx.x;
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

    TabGeo g{};
    double z1 = 0.0;  // bed level of node i+1
    if (node) {
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
        if (cell) z1 = geo[G_ZBED * n + i + 1];
        sh[i] = h0_all[sim * (size_t)n + i];
        sQ[i] = Q0_all[sim * (size_t)n + i];
        cidx[i] = -1;
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

        // -- previous-level state of this node, read by the cells i-1 and i
        //    (LEAN: the closures of the level's first iteration, p0 and p1)
        if constexpr (!LEAN) {
            if (node) {
                const double hp = sh[i], Qp = sQ[i];
                const Sec s = section_state_cached(g, hp, cache, cidx, n, i);
                const Slope e = energy_slope(g, s, hp, Qp);
                prev[X_H * n + i] = hp;   prev[X_Q * n + i] = Qp;
                prev[X_A * n + i] = s.A;  prev[X_SE * n + i] = e.Se;
                prev[X_Q2A * n + i] = Qp * Qp / s.A;
            }
        }
        const double us_target = us_series[k], ds_target = ds_series[k];
        double qavg = 0.0;
        if (cell && qlat_mode != QLAT_NONE) {
            const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * n : qlat;
            const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * n : qlat;
            qavg = 0.5 * theta * (qc[i + 1] + qc[i]) + 0.5 * (1.0 - theta) * (qp[i + 1] + qp[i]);
        }
        if constexpr (!LEAN) {
            __syncthreads();
            probe.mark(PH_PREV);
        }
        NodePrev p0{}, p1{};   // LEAN: node i's and node i+1's level start

        double err = CUDART_INF;
        int it = 0;
        while (err >= tol && it < max_iter) {
            double h = 0.0, Q = 0.0;
            if (node) {
                h = sh[i]; Q = sQ[i];
                const Sec s = section_state_cached(g, h, cache, cidx, n, i);
                const Slope e = energy_slope(g, s, h, Q);
                buf1[0 * n + i] = s.A;      buf1[1 * n + i] = Q * Q / s.A;
                buf1[2 * n + i] = e.Se;     buf1[3 * n + i] = s.dA_dh;
                buf1[4 * n + i] = e.dSe_dA; buf1[5 * n + i] = e.dSe_dQ;
                buf1[6 * n + i] = Q / s.A;  buf1[7 * n + i] = s.K;
                buf1[8 * n + i] = s.dK_dA;
                if constexpr (LEAN) {
                    if (it == 0) p0 = NodePrev{h, Q, s.A, e.Se, Q * Q / s.A};
                }
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
                auto it_of = [&](int m, double hm, double Qm) {
                    return NodeIt{hm, Qm, buf1[0 * n + m], buf1[1 * n + m], buf1[2 * n + m],
                                  buf1[3 * n + m], buf1[4 * n + m], buf1[5 * n + m], buf1[6 * n + m]};
                };
                auto prev_of = [&](int m) {
                    return NodePrev{prev[X_H * n + m], prev[X_Q * n + m], prev[X_A * n + m],
                                    prev[X_SE * n + m], prev[X_Q2A * n + m]};
                };
                const int j = i + 1;
                if constexpr (LEAN) {
                    const NodeIt c1 = it_of(j, sh[j], sQ[j]);
                    if (it == 0) p1 = NodePrev{c1.h, c1.Q, c1.A, c1.Se, c1.Q2A};
                    sq = cell_rows(buf0, n, i, theta, dt, dx, it_of(i, h, Q), c1, p0, p1, (z1 - g.z) / dx,
                                   qlat_mode != QLAT_NONE, qavg);
                } else {
                    sq = cell_rows(buf0, n, i, theta, dt, dx, it_of(i, h, Q), it_of(j, sh[j], sQ[j]), prev_of(i),
                                   prev_of(j), (z1 - g.z) / dx, qlat_mode != QLAT_NONE, qavg);
                }
            }
            if (node && (first || last)) {   // the boundary rows read the node's conveyance
                Sec s{};
                s.A = buf1[0 * n + i]; s.T = buf1[3 * n + i]; s.dA_dh = s.T;
                s.K = buf1[7 * n + i]; s.dK_dA = buf1[8 * n + i];
                double res, df_dh, df_dQ;
                if (first) {  // upstream row: D row 0 of node 0
                    Rating us_rat{};
                    if (us_kind == BC_RATING)
                        us_rat = Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                        par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                        par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                        par[P_URC_FD], 0.0, us_rc_kind};
                    buf0[0 * n + i] = 0.0;   buf0[1 * n + i] = 0.0;
                    boundary_row(us_bc, us_rat, s, h, Q, us_target, gc.open, res, df_dh, df_dQ);
                    buf0[4 * n + i] = df_dh; buf0[5 * n + i] = df_dQ;
                    buf0[12 * n + i] = -res;
                    sq += res * res;
                }
                if (last) {   // downstream row: D row 1 of node N-1
                    buf0[10 * n + i] = 0.0;   buf0[11 * n + i] = 0.0;
                    boundary_row(ds_bc, rat, s, h, Q, ds_target, gc.open, res, df_dh, df_dQ);
                    buf0[6 * n + i] = df_dh;  buf0[7 * n + i] = df_dQ;
                    buf0[13 * n + i] = -res;
                    sq += res * res;
                }
            }
            // the barrier inside also publishes buf0 and retires every read
            // of the exchange area before the first sweep overwrites it
            err = sqrt(block_sum(sq, warp_part[it & 1]));
            probe.mark(PH_ASSEMBLY);

            // the node's own rows stay in registers from sweep to sweep
            double own[pcr::CARRY_COMP];
            double* src = buf0;
            double* dst = buf1;
            int stride = 1;
            for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                if (node) {
                    const bool vm = i - stride >= 0, vp = i + stride < n;
                    const double* pm = vm ? src + (i - stride) : src;
                    const double* pp = vp ? src + (i + stride) : src;
                    if (sw == 0) {
#pragma unroll
                        for (int c = 0; c < COMP; ++c) own[c] = src[c * n + i];
                        pcr::sweep_node_at_carried<1, false, pcr::INV_COMP>(own, pm, pp, dst + i, n, vm, vp);
                    } else {
                        pcr::sweep_node_at_carried<1, true, pcr::INV_COMP>(own, pm, pp, dst + i, n, vm, vp);
                    }
                }
                __syncthreads();
                probe.mark(PH_SWEEPS);
                double* t = src; src = dst; dst = t;
            }
            if (node) {   // backsolve_carried on the rows in registers
                const int v = pcr::INV_COMP;
                sh[i] = h + (own[v + 0] * own[12] + own[v + 1] * own[13]);
                sQ[i] = Q + (own[v + 2] * own[12] + own[v + 3] * own[13]);
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

// -- the long build -------------------------------------------------------------
//
// One simulation of REGISTER_MAX_N < N <= LONG_MAX_N nodes (the TPU
// kernel's MAX_VMEM_N), and any N when a caller forces it.  The register
// build keeps 240 B a node in shared memory with one thread a node, so it
// stops at 964 nodes; this build keeps the same per-node state in a scratch
// of device memory that the wrapper allocates (torch.empty), one a block of
// the grid, LONG_DOUBLES_PER_NODE doubles a node: the two PCR buffers, h and
// Q as in the register build, and the previous level's state and the cell's
// lateral inflow, which the register build holds in registers (a thread
// here owns up to eight nodes).  2.4 MB at N = 8192: one stays in the card's
// 50 MB L2; a batch's 132 do not, and a batch takes the cluster build below.
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

// The long build: the register build's signature; scratch_all [n_sims,
// LONG_DOUBLES_PER_NODE, N] is its per-simulation state, block b running
// simulation b.  STORAGE and TABLE as in the register build; no probe build.
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
                  long long* __restrict__ probe_out, double* scratch_all, int n_sims) {
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

// -- the cluster build ------------------------------------------------------------
//
// Kernel 3 (and, forced, kernel 1) at 965 <= N <= 8192: one member over a
// thread-block cluster of C blocks, its per-node state — the long build's,
// LONG_DOUBLES_PER_NODE doubles a node — in the blocks' shared memory
// instead of a scratch of device memory.  The long build's batch keeps 132
// scratches of 288 B a node in flight (78 MB at N = 2048), beyond the card's
// 50 MB L2, and even one member waits on L2 latency at every exchange.
//
//  * rank r of the cluster owns the nodes r * rn .. r * rn + rn - 1, rn =
//    blockDim.x, a multiple of 32, one node a thread; C is the fewest blocks
//    (at least 2) at which rn <= CLUSTER_BLOCK (3 at N = 2048, 6 at 4096, 11
//    at 8192; above 8 a non-portable cluster size);
//  * each rank keeps its nodes of the two PCR buffers, h, Q, the previous
//    level's state and the cell inflow in its shared memory, in the long
//    build's layout with leading dimension rn; a partner across the rank's
//    edge (node i+1 in the assembly, i -/+ s in a sweep) is read, and node
//    i+1's cell row written, through distributed shared memory;
//  * each node's operations are the long build's, in its order (its own
//    rows held in registers from sweep to sweep, pcr::sweep_node_at_own, and
//    the boundary node's section kept from the closures rather than formed
//    again: the same values); phases are separated by cluster barriers; the
//    storage and boundary rows stay with the ranks that own nodes 0 and N-1;
//  * the residual norm in the long build's association: the cluster's thread
//    g < LONG_BLOCK adds the squared residuals of the nodes g, g + 1024, ...
//    in order (those from node 1024 on through DSMEM, one double a node
//    more), its warp's tree follows, and thread 0 of every rank adds the 32
//    warps' partials in order after the first sweep's barrier, ready for the
//    loop test after the last: the long build's norm, so every field of
//    every simulation has the long build's bits (and, forced at N <= 964,
//    the register build's);
//  * the grid is persistent: as many clusters as the card holds at once,
//    each running the members clusterIdx, clusterIdx + clusters, ...
constexpr int CLUSTER_BLOCK = 768;      // nodes (threads) a rank: 768 x 296 B within 227 KB
constexpr int CLUSTER_DOUBLES_PER_NODE = LONG_DOUBLES_PER_NODE + 1;   // and the node's squared residuals
constexpr int MAX_LONG_CLUSTER = 16;    // blocks of a cluster (above 8: non-portable)
static_assert(LONG_MAX_N <= MAX_LONG_CLUSTER * CLUSTER_BLOCK, "every long reach fits a cluster");

namespace cg = cooperative_groups;

__host__ __device__ inline int round32(int x) { return (x + 31) / 32 * 32; }

// nodes a rank of a cluster of `blocks` blocks holds at N nodes
__host__ __device__ inline int rank_nodes(int n, int blocks) { return round32((n + blocks - 1) / blocks); }

// The cluster build: the register build's signature.  PROBE: its probe
// build (trapezoid geometry without storage): thread 0 of rank 0 of the
// first cluster, over all its members; the closures' barrier ends the
// previous iteration's back-substitution and this level's previous state
// with them, the level's last back-substitution ends at PH_BACKSOLVE.
template <bool STORAGE, bool TABLE, bool PROBE>
__global__ void __launch_bounds__(CLUSTER_BLOCK, 1)
fused_cluster_kernel(const double* __restrict__ geo_all, const double* __restrict__ h0_all,
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
                     long long* __restrict__ probe_out, double* scratch_all, int n_sims) {
    extern __shared__ double smem[];
    __shared__ double warp_part[2][32];
    __shared__ double err_part[2];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), n_ranks = (int)cluster.num_blocks();
    const int rn = blockDim.x;              // nodes a rank
    const int t0 = threadIdx.x;
    const int i = rank * rn + t0;           // this thread's node
    const bool node = i < n;
    const bool cell = i < n - 1;
    const bool first = i == 0;
    const bool last = i == n - 1;

    double* buf0 = smem;                       // the system / PCR ping, [COMP][rn]
    double* buf1 = buf0 + (size_t)COMP * rn;   // neighbour exchange / PCR pong
    double* sh = buf1 + (size_t)COMP * rn;     // depth per node
    double* sQ = sh + rn;                      // discharge per node
    double* prev = sQ + rn;                    // [L_COUNT][rn]
    double* sqn = prev + (size_t)L_COUNT * rn;  // a node's squared residuals (from node LONG_BLOCK on)
    // node m's element of the array at `base` (component c at [c * rn]),
    // in whichever rank holds it
    auto at = [&](double* base, int m) -> double* {
        const int q = m / rn, x = m - q * rn;
        return q == rank ? base + x : cluster.map_shared_rank(base + x, q);
    };
    Probe<PROBE> probe;
    probe.start();

    for (size_t sim = blockIdx.x / n_ranks; sim < (size_t)n_sims; sim += gridDim.x / n_ranks) {
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

    const double theta = par[P_THETA], dt = par[P_DT], dx = par[P_DX], tol = par[P_TOL];
    Bc us_bc{par[P_US_BED_LEVEL], par[P_US_BED_SLOPE], par[P_US_INIT_DEPTH], us_kind};
    Bc ds_bc{par[P_DS_BED_LEVEL], par[P_DS_BED_SLOPE], par[P_DS_INIT_DEPTH], ds_kind};
    Rating rat{par[P_RC_LOW0], par[P_RC_LOW1], par[P_RC_LOW2],
               par[P_RC_HIGH0], par[P_RC_HIGH1], par[P_RC_HIGH2],
               par[P_RC_SHIFT], par[P_RC_PIVOT], par[P_RC_BUFFER], par[P_RC_FD],
               par[P_RC_COOLDOWN], rc_kind};
    const bool gated = (ds_kind == BC_RATING) && (rc_kind == RC_GATED);
    auto geo_of = [&](int m) { return node_geo<TABLE>(geo, n, m, sim, tab_shared, tab_k, tab_neq, tab_dk, tab_m); };

    if (node) {
        sh[t0] = h0_all[sim * (size_t)n + i];
        sQ[t0] = Q0_all[sim * (size_t)n + i];
    }
#define STORE_LEVEL(k)                                                                     \
    if (store_boundaries) {                                                                \
        if (first) { depth[(size_t)(k) * 2] = sh[t0]; flow[(size_t)(k) * 2] = sQ[t0]; }     \
        if (last) { depth[(size_t)(k) * 2 + 1] = sh[t0]; flow[(size_t)(k) * 2 + 1] = sQ[t0]; } \
    } else if (node) {                                                                     \
        depth[(size_t)(k) * n + i] = sh[t0];                                               \
        flow[(size_t)(k) * n + i] = sQ[t0];                                                \
    }
    STORE_LEVEL(0)
    GateCtl gc{par[P_GATE_INIT]};
    if (first) { iters[0] = 0; errs[0] = 0.0; conv[0] = 1; gate[0] = gc.open; }
    cluster.sync();
    probe.mark(PH_LEVEL);
    double gate_stage = ds_bc.bed_level + *at(sh, n - 1);

    for (int k = 1; k < nt; ++k) {
        if (gated) gc.step(rat, k, dt, gate_stage);

        // -- previous-level state and the cell's lateral inflow of this node
        //    (published by the closures' barrier)
        if (node) {
            const auto g = geo_of(i);
            const double hp = sh[t0], Qp = sQ[t0];
            const Sec s = section_state(g, hp);
            const Slope e = energy_slope(g, s, hp, Qp);
            prev[L_H * rn + t0] = hp;   prev[L_Q * rn + t0] = Qp;
            prev[L_A * rn + t0] = s.A;  prev[L_SE * rn + t0] = e.Se;
            prev[L_Q2A * rn + t0] = Qp * Qp / s.A;
            if (cell && qlat_mode != QLAT_NONE) {
                const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * n : qlat;
                const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * n : qlat;
                prev[L_QAVG * rn + t0] = 0.5 * theta * (qc[i + 1] + qc[i]) + 0.5 * (1.0 - theta) * (qp[i + 1] + qp[i]);
            }
        }
        const double us_target = us_series[k], ds_target = ds_series[k];

        double err = CUDART_INF;
        int it = 0;
        while (err >= tol && it < max_iter) {
            if (node) {
                const auto g = geo_of(i);
                const double h = sh[t0], Q = sQ[t0];
                const Sec s = section_state(g, h);
                const Slope e = energy_slope(g, s, h, Q);
                buf1[0 * rn + t0] = s.A;      buf1[1 * rn + t0] = Q * Q / s.A;
                buf1[2 * rn + t0] = e.Se;     buf1[3 * rn + t0] = s.dA_dh;
                buf1[4 * rn + t0] = e.dSe_dA; buf1[5 * rn + t0] = e.dSe_dQ;
                buf1[6 * rn + t0] = Q / s.A;
                if (first || last) {   // what the boundary and storage rows read of the section
                    buf1[7 * rn + t0] = s.R;      buf1[8 * rn + t0] = s.n_eq;
                    buf1[9 * rn + t0] = s.dR_dA;  buf1[10 * rn + t0] = s.K;
                    buf1[11 * rn + t0] = s.dK_dA;
                }
            }
            cluster.sync();
            probe.mark(PH_CLOSURES);

            double sq = 0.0;
            if (node) {
                const double h = sh[t0], Q = sQ[t0];
                double sq_i = 0.0;
                buf0[2 * rn + t0] = 0.0; buf0[3 * rn + t0] = 0.0;
                buf0[8 * rn + t0] = 0.0; buf0[9 * rn + t0] = 0.0;
                auto prev_of = [&](const double* p) {
                    return NodePrev{p[L_H * rn], p[L_Q * rn], p[L_A * rn], p[L_SE * rn], p[L_Q2A * rn]};
                };
                if (cell) {
                    const int j = i + 1;
                    auto it_of = [&](const double* c, double hm, double Qm) {
                        return NodeIt{hm, Qm, c[0 * rn], c[1 * rn], c[2 * rn], c[3 * rn], c[4 * rn], c[5 * rn],
                                      c[6 * rn]};
                    };
                    sq_i = cell_rows<true>(buf0, rn, t0, theta, dt, dx, it_of(buf1 + t0, h, Q),
                                           it_of(at(buf1, j), *at(sh, j), *at(sQ, j)), prev_of(prev + t0),
                                           prev_of(at(prev, j)), (geo[G_ZBED * n + j] - geo[G_ZBED * n + i]) / dx,
                                           qlat_mode != QLAT_NONE, prev[L_QAVG * rn + t0], at(buf0, j));
                }
                if (first || last) {
                    // the boundary node's section at this iterate, kept by the
                    // closures (the long build forms it again: the same bits)
                    Sec s{};
                    s.A = buf1[0 * rn + t0];   s.dA_dh = buf1[3 * rn + t0];
                    s.R = buf1[7 * rn + t0];   s.n_eq = buf1[8 * rn + t0];
                    s.dR_dA = buf1[9 * rn + t0];
                    s.K = buf1[10 * rn + t0];  s.dK_dA = buf1[11 * rn + t0];
                    const double hp = prev[L_H * rn + t0], Qp = prev[L_Q * rn + t0];
                    double res, df_dh, df_dQ;
                    if (first) {   // upstream row: D row 0 of node 0
                        Rating us_rat{};
                        if (us_kind == BC_RATING)
                            us_rat = Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                            par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                            par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                            par[P_URC_FD], 0.0, us_rc_kind};
                        buf0[0 * rn + t0] = 0.0;   buf0[1 * rn + t0] = 0.0;
                        if (us_stor) {
                            const double Y_old = k == 1 ? hp + us_bc.bed_level : stage[(size_t)(k - 1) * 2 + 1];
                            res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT),
                                              stab_all + sim * (size_t)stab_stride, us_sflags, us_nv, us_na, us_nr,
                                              -1.0, us_bc.bed_level, dt, Qp, Y_old, s.A, s.R, s.n_eq, s.dR_dA,
                                              s.dA_dh, h, Q, &buf0[4 * rn + t0], &buf0[5 * rn + t0],
                                              &buf0[12 * rn + t0], &stage[(size_t)k * 2 + 1]);
                            if (!ds_stor) stage[(size_t)k * 2] = stage[(size_t)k * 2 + 1];
                        } else {
                            boundary_row(us_bc, us_rat, s, h, Q, us_target, gc.open, res, df_dh, df_dQ);
                            buf0[4 * rn + t0] = df_dh; buf0[5 * rn + t0] = df_dQ;
                            buf0[12 * rn + t0] = -res;
                        }
                        sq_i += res * res;
                    }
                    if (last) {   // downstream row: D row 1 of node N-1
                        buf0[10 * rn + t0] = 0.0;   buf0[11 * rn + t0] = 0.0;
                        if (ds_stor) {
                            const double Y_old = k == 1 ? h + ds_bc.bed_level : stage[(size_t)(k - 1) * 2];
                            res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT) + SP_COUNT,
                                              stab_all + sim * (size_t)stab_stride + 2 * (us_nv + us_na) + us_nr,
                                              ds_sflags, ds_nv, ds_na, ds_nr, 1.0, ds_bc.bed_level, dt, Qp, Y_old,
                                              s.A, s.R, s.n_eq, s.dR_dA, s.dA_dh, h, Q, &buf0[6 * rn + t0],
                                              &buf0[7 * rn + t0], &buf0[13 * rn + t0], &stage[(size_t)k * 2]);
                        } else {
                            boundary_row(ds_bc, rat, s, h, Q, ds_target, gc.open, res, df_dh, df_dQ);
                            buf0[6 * rn + t0] = df_dh;  buf0[7 * rn + t0] = df_dQ;
                            buf0[13 * rn + t0] = -res;
                        }
                        sq_i += res * res;
                    }
                }
                sq += sq_i;
            }
            // the long build's norm: its thread g (< LONG_BLOCK) adds the
            // nodes g, g + LONG_BLOCK, ... in order, then block_sum.  Here
            // the cluster's thread g, whose node is g, does that (a node from
            // LONG_BLOCK on published in sqn); the warps of those threads
            // keep their partials, and thread 0 of every rank adds them after
            // the first sweep's barrier
            if (node && i >= LONG_BLOCK) sqn[t0] = sq;
            cluster.sync();   // publishes the system and sqn
            probe.mark(PH_ASSEMBLY);
            if (i < LONG_BLOCK) {   // whole warps: rn and LONG_BLOCK are multiples of 32
                double v = 0.0;
                v += sq;
                for (int m = i + LONG_BLOCK; m < n; m += LONG_BLOCK) v += *at(sqn, m);
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
                if ((t0 & 31) == 0) warp_part[it & 1][t0 >> 5] = v;
            }

            // the node's own rows stay in registers from sweep to sweep
            double own[COMP];
#pragma unroll
            for (int c = 0; c < COMP; ++c) own[c] = node ? buf0[c * rn + t0] : 0.0;
            double* src = buf0;
            double* dst = buf1;
            int stride = 1;
            for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                if (node) {
                    const bool vm = i - stride >= 0, vp = i + stride < n;
                    pcr::sweep_node_at_own<1>(own, vm ? at(src, i - stride) : src, vp ? at(src, i + stride) : src,
                                              dst + t0, rn, vm, vp);
                }
                cluster.sync();
                probe.mark(PH_SWEEPS);
                double* t = src; src = dst; dst = t;
                if (sw == 0 && t0 == 0) {   // block_sum's sum of the long build's warps, in order
                    double total = 0.0;
                    for (int g = 0; g < LONG_BLOCK && g < n_ranks * rn; g += 32) {
                        const int q = g / rn;
                        total += *cluster.map_shared_rank(&warp_part[it & 1][(g - q * rn) >> 5], q);
                    }
                    err_part[it & 1] = total;
                }
            }
            if (sweeps < 2) __syncthreads();
            err = sqrt(err_part[it & 1]);   // published by a later sweep's barrier
            if (node) {   // backsolve_node on the rows in registers
                double i00, i01, i10, i11;
                pcr::inv2(own[4], own[5], own[6], own[7], i00, i01, i10, i11);
                sh[t0] = sh[t0] + (i00 * own[12] + i01 * own[13]);
                sQ[t0] = sQ[t0] + (i10 * own[12] + i11 * own[13]);
            }
            ++it;
            // no barrier: the next closures touch this thread's node alone,
            // and the barrier after them orders every other read
        }

        cluster.sync();   // every rank's update done: node N-1 is read below
        probe.mark(PH_BACKSOLVE);
        STORE_LEVEL(k)
        gate_stage = ds_bc.bed_level + *at(sh, n - 1);
        if (first) {
            iters[k] = it;
            errs[k] = err;
            conv[k] = err < tol ? 1 : 0;
            gate[k] = gc.open;
        }
    }
    // no rank starts the next member, or exits, while another reads its state
    cluster.sync();
#undef STORE_LEVEL
    }
    probe.write(probe_out);
}

// -- the reach build --------------------------------------------------------------
//
// Kernel 1 at 965 <= N <= 8192: one simulation, which has the whole card,
// over a thread-block cluster of C blocks sized for the latency of an
// iteration rather than for fit (REACH_RANKS: 16 blocks, the most a cluster
// takes, non-portable above 8).  The long build above runs such a reach on
// one SM of 132, up to eight nodes a thread with its state in device memory;
// the cluster build fits a batch's member to the fewest blocks that hold it,
// one thread a node, with a cluster barrier after every step.  This build:
//
//  * lays the nodes out cyclically: rank q of C (a power of two) holds the
//    nodes q, q + C, q + 2C, ... (node i at index i / C of rank i % C), rn =
//    32 ceil(N / 32 C) a rank.  A PCR sweep of stride s >= C then finds both
//    partners (i -/+ s, index -/+ s / C) in its own rank and ends on a block
//    barrier with no DSMEM read; only the first log2 C sweeps, whose partners
//    lie in other ranks, end on a cluster barrier (4 of 12 at N = 2409 and C
//    = 16).  The assembly reads node i+1's closures and previous state, and
//    writes its cell row, in rank (q + 1) % C through DSMEM;
//  * forms the closures on LN = LANES = 2 threads a node, the latency
//    build's closures_lanes (trapezoid geometry; on tables the lead lane
//    forms section_state), 2 rn threads a rank, the assembly, the sweeps and
//    the update one thread a node on the first rn — up to 256 nodes a rank
//    (N <= 4096), under a launch bound of 512 threads (128 registers).  At
//    N > 4096 (512 nodes a rank) LN = 1: one thread a node for every phase,
//    section_state as the long build forms it, 512 threads (1024 threads
//    would leave 64 registers, and closures_lanes spilled 1.8 KB there);
//  * sweeps with the carried inverse, each node's own rows in registers
//    (pcr::sweep_node_at_carried: 14 components a buffer, the inverse in D's
//    place), and the storage and boundary rows read the section the closures
//    kept (what the long build forms again: the same bits);
//  * keeps the long build's norm association: each node's squared residuals
//    are published (sqn), and during the first sweep the threads that have no
//    node in the sweeps (LN = 2; at LN = 1 every thread, after its sweep)
//    form the long build's 32 warp partials (its thread g adds the nodes g,
//    g + 1024, ... in order, then the warp's shuffle tree); one thread adds
//    the 32 partials in order after that sweep's barrier, ready for the loop
//    test after the last.
//
// So every field has the long build's bits (and, forced at N <= 964, the
// register build's).  37 doubles a node (296 B); one cluster a simulation (a
// forced batch: a grid of one cluster a member).
constexpr int REACH_RANKS = 16;
constexpr int REACH_BLOCK = 512;            // the launch bound: 128 registers
constexpr int REACH_MAX_RANK_NODES = 512;   // one thread a node
constexpr int REACH_DOUBLES_PER_NODE = 2 * COMP + 2 + L_COUNT + 1;
static_assert(LONG_MAX_N <= REACH_RANKS * REACH_MAX_RANK_NODES, "every long reach fits the reach build");

// The reach build: the register build's signature.  LN: the closures' lanes
// a node (2: closures_lanes; 1: section_state), blockDim.x = LN rn.  PROBE:
// its probe build (trapezoid geometry without storage; thread 0 of rank 0:
// the closures' barrier ends the previous level's state with them).
template <bool STORAGE, bool TABLE, bool PROBE, int LN>
__global__ void __launch_bounds__(REACH_BLOCK, 1)
fused_reach_kernel(const double* __restrict__ geo_all, const double* __restrict__ h0_all,
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
                   long long* __restrict__ probe_out, double* scratch_all, int n_sims) {
    extern __shared__ double smem[];
    __shared__ double warp_part[2][32];
    __shared__ double err_part[2];

    cg::cluster_group cluster = cg::this_cluster();
    const int q = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
    const int lg = __ffs(C) - 1;           // C = 2^lg
    const int rn = blockDim.x / LN;        // nodes a rank, a multiple of 32
    const int t0 = threadIdx.x;
    // the node of the assembly, the norm, the sweeps and the update (t0 < rn)
    const bool rows = t0 < rn;
    const int i = (t0 << lg) + q;
    const bool node = rows && i < n;
    const bool cell = rows && i < n - 1;
    const bool first = rows && i == 0;
    const bool last = rows && i == n - 1;
    // the closures' node (index ci of this rank, LN lanes each; a padding
    // node computes as node N-1 and stores nothing)
    const int ci = t0 / LN, lane = t0 % LN;
    const int gi = (ci << lg) + q;
    const bool clead = gi < n && lane == 0;

    double* buf0 = smem;                         // the system / sweep ping, [COMP][rn]
    double* buf1 = buf0 + (size_t)COMP * rn;     // closures / sweep pong
    double* sh = buf1 + (size_t)COMP * rn;       // depth per node
    double* sQ = sh + rn;                        // discharge per node
    double* prev = sQ + rn;                      // [L_COUNT][rn]
    double* sqn = prev + (size_t)L_COUNT * rn;   // a node's squared residuals
    // the threads that form the norm's partials: those with no node in the
    // sweeps (LN = 2), else every thread
    const int g0 = LN > 1 ? rn : 0;
    // node m's element of the array at `base` (component c at [c * rn]), in
    // whichever rank holds it
    auto at = [&](double* base, int m) -> double* {
        const int r = m & (C - 1), x = m >> lg;
        return r == q ? base + x : cluster.map_shared_rank(base + x, r);
    };

    const size_t sim = blockIdx.x / C;
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

    const double theta = par[P_THETA], dt = par[P_DT], dx = par[P_DX], tol = par[P_TOL];
    Bc us_bc{par[P_US_BED_LEVEL], par[P_US_BED_SLOPE], par[P_US_INIT_DEPTH], us_kind};
    Bc ds_bc{par[P_DS_BED_LEVEL], par[P_DS_BED_SLOPE], par[P_DS_INIT_DEPTH], ds_kind};
    Rating rat{par[P_RC_LOW0], par[P_RC_LOW1], par[P_RC_LOW2],
               par[P_RC_HIGH0], par[P_RC_HIGH1], par[P_RC_HIGH2],
               par[P_RC_SHIFT], par[P_RC_PIVOT], par[P_RC_BUFFER], par[P_RC_FD],
               par[P_RC_COOLDOWN], rc_kind};
    const bool gated = (ds_kind == BC_RATING) && (rc_kind == RC_GATED);

    // the closures' node's geometry, held for the run, and the cell's bed slope
    constexpr bool ONE_LANE = TABLE || LN == 1;   // section_state on the lead lane
    const int cc = gi < n ? gi : n - 1;
    typename std::conditional<TABLE, TabGeo, typename std::conditional<LN == 1, Geo, GeoL>::type>::type g;
    if constexpr (ONE_LANE) g = node_geo<TABLE>(geo, n, cc, sim, tab_shared, tab_k, tab_neq, tab_dk, tab_m);
    else g = geo_terms(geo, n, cc);
    const double gz = cell ? (geo[G_ZBED * n + i + 1] - geo[G_ZBED * n + i]) / dx : 0.0;
    const double cbrt1 = cbrt_polished(1.0);
    const double icbrt1 = 1.0 / cbrt1;
    // node ci's closures at (h, Q), every lane of the node calling
    auto closures = [&](double h, double Q) {
        ClosL c{};
        if constexpr (ONE_LANE) {
            if (clead) {
                const Sec s = section_state(g, h);
                const Slope e = energy_slope(g, s, h, Q);
                c.A = s.A; c.T = s.dA_dh; c.K = s.K; c.dK_dA = s.dK_dA;
                c.Se = e.Se; c.dSe_dA = e.dSe_dA; c.dSe_dQ = e.dSe_dQ;
                c.QA = Q / s.A; c.Q2A = Q * Q / s.A;
                c.R = s.R; c.n_eq = s.n_eq; c.dR_dA = s.dR_dA;
            }
        } else {
            c = closures_lanes(g, h, Q, lane, cbrt1, icbrt1);
        }
        return c;
    };

    if (rows) {
        sh[t0] = node ? h0_all[sim * (size_t)n + i] : 0.0;
        sQ[t0] = node ? Q0_all[sim * (size_t)n + i] : 0.0;
    }
#define STORE_LEVEL(k)                                                                     \
    if (store_boundaries) {                                                                \
        if (first) { depth[(size_t)(k) * 2] = sh[t0]; flow[(size_t)(k) * 2] = sQ[t0]; }     \
        if (last) { depth[(size_t)(k) * 2 + 1] = sh[t0]; flow[(size_t)(k) * 2 + 1] = sQ[t0]; } \
    } else if (node) {                                                                     \
        depth[(size_t)(k) * n + i] = sh[t0];                                               \
        flow[(size_t)(k) * n + i] = sQ[t0];                                                \
    }
    STORE_LEVEL(0)
    GateCtl gc{par[P_GATE_INIT]};
    if (first) { iters[0] = 0; errs[0] = 0.0; conv[0] = 1; gate[0] = gc.open; }
    Probe<PROBE> probe;
    probe.start();
    cluster.sync();
    probe.mark(PH_LEVEL);
    double gate_stage = ds_bc.bed_level + *at(sh, n - 1);

    for (int k = 1; k < nt; ++k) {
        if (gated) gc.step(rat, k, dt, gate_stage);

        // -- previous-level state of node ci, and the cell's lateral inflow
        //    of node i (published by the closures' barrier)
        {
            const double hp = sh[ci], Qp = sQ[ci];
            const ClosL cp = closures(hp, Qp);
            if (clead) {
                prev[L_H * rn + ci] = hp;    prev[L_Q * rn + ci] = Qp;
                prev[L_A * rn + ci] = cp.A;  prev[L_SE * rn + ci] = cp.Se;
                prev[L_Q2A * rn + ci] = cp.Q2A;
            }
        }
        if (cell && qlat_mode != QLAT_NONE) {
            const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * n : qlat;
            const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * n : qlat;
            prev[L_QAVG * rn + t0] = 0.5 * theta * (qc[i + 1] + qc[i]) + 0.5 * (1.0 - theta) * (qp[i + 1] + qp[i]);
        }
        const double us_target = us_series[k], ds_target = ds_series[k];

        double err = CUDART_INF;
        int it = 0;
        while (err >= tol && it < max_iter) {
            {
                const ClosL c = closures(sh[ci], sQ[ci]);
                if (clead) {
                    buf1[0 * rn + ci] = c.A;      buf1[1 * rn + ci] = c.Q2A;
                    buf1[2 * rn + ci] = c.Se;     buf1[3 * rn + ci] = c.T;
                    buf1[4 * rn + ci] = c.dSe_dA; buf1[5 * rn + ci] = c.dSe_dQ;
                    buf1[6 * rn + ci] = c.QA;
                    if (gi == 0 || gi == n - 1) {   // what the boundary and storage rows read of the section
                        buf1[7 * rn + ci] = c.R;      buf1[8 * rn + ci] = c.n_eq;
                        buf1[9 * rn + ci] = c.dR_dA;  buf1[10 * rn + ci] = c.K;
                        buf1[11 * rn + ci] = c.dK_dA;
                    }
                }
            }
            cluster.sync();
            probe.mark(PH_CLOSURES);

            double sq = 0.0;
            if (node) {
                const double h = sh[t0], Q = sQ[t0];
                double sq_i = 0.0;
                buf0[2 * rn + t0] = 0.0; buf0[3 * rn + t0] = 0.0;
                buf0[8 * rn + t0] = 0.0; buf0[9 * rn + t0] = 0.0;
                auto prev_of = [&](const double* p) {
                    return NodePrev{p[L_H * rn], p[L_Q * rn], p[L_A * rn], p[L_SE * rn], p[L_Q2A * rn]};
                };
                if (cell) {
                    const int j = i + 1;
                    auto it_of = [&](const double* c, double hm, double Qm) {
                        return NodeIt{hm, Qm, c[0 * rn], c[1 * rn], c[2 * rn], c[3 * rn], c[4 * rn], c[5 * rn],
                                      c[6 * rn]};
                    };
                    sq_i = cell_rows<true>(buf0, rn, t0, theta, dt, dx, it_of(buf1 + t0, h, Q),
                                           it_of(at(buf1, j), *at(sh, j), *at(sQ, j)), prev_of(prev + t0),
                                           prev_of(at(prev, j)), gz, qlat_mode != QLAT_NONE,
                                           prev[L_QAVG * rn + t0], at(buf0, j));
                }
                if (first || last) {
                    // the boundary node's section at this iterate, kept by the
                    // closures (the long build forms it again: the same bits)
                    Sec s{};
                    s.A = buf1[0 * rn + t0];   s.T = buf1[3 * rn + t0];   s.dA_dh = s.T;
                    s.R = buf1[7 * rn + t0];   s.n_eq = buf1[8 * rn + t0];
                    s.dR_dA = buf1[9 * rn + t0];
                    s.K = buf1[10 * rn + t0];  s.dK_dA = buf1[11 * rn + t0];
                    const double hp = prev[L_H * rn + t0], Qp = prev[L_Q * rn + t0];
                    double res, df_dh, df_dQ;
                    if (first) {   // upstream row: D row 0 of node 0
                        Rating us_rat{};
                        if (us_kind == BC_RATING)
                            us_rat = Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                            par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                            par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                            par[P_URC_FD], 0.0, us_rc_kind};
                        buf0[0 * rn + t0] = 0.0;   buf0[1 * rn + t0] = 0.0;
                        if (us_stor) {
                            const double Y_old = k == 1 ? hp + us_bc.bed_level : stage[(size_t)(k - 1) * 2 + 1];
                            res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT),
                                              stab_all + sim * (size_t)stab_stride, us_sflags, us_nv, us_na, us_nr,
                                              -1.0, us_bc.bed_level, dt, Qp, Y_old, s.A, s.R, s.n_eq, s.dR_dA,
                                              s.dA_dh, h, Q, &buf0[4 * rn + t0], &buf0[5 * rn + t0],
                                              &buf0[12 * rn + t0], &stage[(size_t)k * 2 + 1]);
                            if (!ds_stor) stage[(size_t)k * 2] = stage[(size_t)k * 2 + 1];
                        } else {
                            boundary_row(us_bc, us_rat, s, h, Q, us_target, gc.open, res, df_dh, df_dQ);
                            buf0[4 * rn + t0] = df_dh; buf0[5 * rn + t0] = df_dQ;
                            buf0[12 * rn + t0] = -res;
                        }
                        sq_i += res * res;
                    }
                    if (last) {   // downstream row: D row 1 of node N-1
                        buf0[10 * rn + t0] = 0.0;   buf0[11 * rn + t0] = 0.0;
                        if (ds_stor) {
                            const double Y_old = k == 1 ? h + ds_bc.bed_level : stage[(size_t)(k - 1) * 2];
                            res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT) + SP_COUNT,
                                              stab_all + sim * (size_t)stab_stride + 2 * (us_nv + us_na) + us_nr,
                                              ds_sflags, ds_nv, ds_na, ds_nr, 1.0, ds_bc.bed_level, dt, Qp, Y_old,
                                              s.A, s.R, s.n_eq, s.dR_dA, s.dA_dh, h, Q, &buf0[6 * rn + t0],
                                              &buf0[7 * rn + t0], &buf0[13 * rn + t0], &stage[(size_t)k * 2]);
                        } else {
                            boundary_row(ds_bc, rat, s, h, Q, ds_target, gc.open, res, df_dh, df_dQ);
                            buf0[6 * rn + t0] = df_dh;  buf0[7 * rn + t0] = df_dQ;
                            buf0[13 * rn + t0] = -res;
                        }
                        sq_i += res * res;
                    }
                }
                sq += sq_i;
            }
            if (rows) sqn[t0] = sq;
            cluster.sync();   // publishes the system and sqn
            probe.mark(PH_ASSEMBLY);

            // the node's own rows, and its inverse of D, in registers from
            // sweep to sweep
            double o[COMP + 4];
#pragma unroll
            for (int c = 0; c < COMP; ++c) o[c] = node ? buf0[c * rn + t0] : 0.0;
            double* src = buf0;
            double* dst = buf1;
            int stride = 1;
            for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                if (node) {
                    const bool vm = i - stride >= 0, vp = i + stride < n;
                    const double* pm = vm ? at(src, i - stride) : src;
                    const double* pp = vp ? at(src, i + stride) : src;
                    if (sw == 0) pcr::sweep_node_at_carried<1, false>(o, pm, pp, dst + t0, rn, vm, vp);
                    else pcr::sweep_node_at_carried<1, true>(o, pm, pp, dst + t0, rn, vm, vp);
                }
                if (sw == 0 && t0 >= g0) {
                    // the long build's partial of its warp w (threads 32 w ..
                    // 32 w + 31): lane l adds the nodes 32 w + l, + LONG_BLOCK,
                    // ... in order, then the shuffle tree; warp w's partial is
                    // kept by rank w % C at w / C
                    const int l = t0 & 31, nw = ((int)blockDim.x - g0) >> 5;
                    for (int w = (((t0 - g0) >> 5) << lg) + q; w < 32 && 32 * w < n; w += nw << lg) {
                        double v = 0.0;
                        for (int m = 32 * w + l; m < n; m += LONG_BLOCK) v += *at(sqn, m);
#pragma unroll
                        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
                        if (l == 0) warp_part[it & 1][w >> lg] = v;
                    }
                }
                // partners in other ranks below stride C; in this rank from there on
                if (stride < C) cluster.sync();
                else __syncthreads();
                probe.mark(PH_SWEEPS);
                if (sw == 0 && t0 == (int)blockDim.x - 1) {   // block_sum's sum of the long build's warps, in order
                    double total = 0.0;
                    for (int w = 0; w < 32 && 32 * w < n; ++w)
                        total += *cluster.map_shared_rank(&warp_part[it & 1][w >> lg], w & (C - 1));
                    err_part[it & 1] = total;
                }
                double* t = src; src = dst; dst = t;
            }
            if (sweeps < 2) __syncthreads();
            err = sqrt(err_part[it & 1]);   // published by a later sweep's barrier
            if (node) {   // backsolve_node on the rows in registers
                sh[t0] = sh[t0] + (o[COMP + 0] * o[12] + o[COMP + 1] * o[13]);
                sQ[t0] = sQ[t0] + (o[COMP + 2] * o[12] + o[COMP + 3] * o[13]);
            }
            ++it;
            if constexpr (LN > 1) __syncthreads();   // the closures' lanes read the update
            probe.mark(PH_BACKSOLVE);
        }

        cluster.sync();   // every rank's update done: node N-1 is read below
        probe.mark(PH_LEVEL);
        STORE_LEVEL(k)
        gate_stage = ds_bc.bed_level + *at(sh, n - 1);
        if (first) {
            iters[k] = it;
            errs[k] = err;
            conv[k] = err < tol ? 1 : 0;
            gate[k] = gc.open;
        }
    }
    // no rank exits while another reads its shared memory
    cluster.sync();
    probe.write(probe_out);
#undef STORE_LEVEL
}

// Every build has one signature: a build is a kernel pointer, its block, its
// dynamic shared memory and (the cluster build) the blocks of its cluster.
using KernelFn = decltype(&fused_simulate_kernel<128, false, 1, false, false>);
struct Build { KernelFn fn; int threads; size_t smem; int cluster = 1; };

// REGISTER_BUILD: N <= REGISTER_MAX_N; RESIDENCY_BUILD: N <= 128 without
// storage; LATENCY_BUILD: N <= 128 without storage, trapezoid geometry;
// LONG_BUILD: every N up to LONG_MAX_N, with a scratch in device memory a
// simulation; BRACKET_BUILD: N <= 128 without storage, table geometry;
// CLUSTER_BUILD: every N up to LONG_MAX_N, one simulation over a
// thread-block cluster, on a persistent grid of clusters; REACH_BUILD: every
// N up to LONG_MAX_N, one simulation over a cluster of REACH_RANKS blocks;
// LEAN_BUILD: N <= 128 without storage, table geometry.
enum { REGISTER_BUILD = 0, RESIDENCY_BUILD = 1, LATENCY_BUILD = 2, LONG_BUILD = 3, BRACKET_BUILD = 4,
       CLUSTER_BUILD = 5, REACH_BUILD = 6, LEAN_BUILD = 7 };

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

KernelFn cluster_build(bool storage, bool table) {
    if (table) return storage ? &fused_cluster_kernel<true, true, false> : &fused_cluster_kernel<false, true, false>;
    return storage ? &fused_cluster_kernel<true, false, false> : &fused_cluster_kernel<false, false, false>;
}

template <int LN>
KernelFn reach_build(bool storage, bool table) {
    if (table) return storage ? &fused_reach_kernel<true, true, false, LN> : &fused_reach_kernel<false, true, false, LN>;
    return storage ? &fused_reach_kernel<true, false, false, LN> : &fused_reach_kernel<false, false, false, LN>;
}

// The reach build's kernel of `lanes` closure lanes a node; its probe
// build: trapezoid geometry without storage.
KernelFn reach_kernel(bool storage, bool table, bool probe, int lanes) {
    if (probe) return lanes == 2 ? &fused_reach_kernel<false, false, true, 2> : &fused_reach_kernel<false, false, true, 1>;
    return lanes == 2 ? reach_build<2>(storage, table) : reach_build<1>(storage, table);
}

// The reach build's closure lanes a node at N nodes (REACH_RANKS blocks):
// LANES while LANES rank_nodes threads fit its 512-thread launch bound
// (N <= 4096), else one.  Measured on an H100 (PERF.md §6): 16 blocks beat
// 8 and 4 at every N, two lanes beat one up to 4096 nodes.
int reach_lanes(int n) {
    return LANES * rank_nodes(n, REACH_RANKS) <= REACH_BLOCK ? LANES : 1;
}

// the blocks of the cluster build's cluster at N nodes: the fewest (at least
// 2) at which a rank holds at most CLUSTER_BLOCK nodes
int cluster_blocks_for(int n) {
    int c = 2;
    while (rank_nodes(n, c) > CLUSTER_BLOCK) ++c;
    return c;
}

// REGISTER_BUILD: the block size alone is the launch bound, so a small reach
// gets the full register budget (250 registers at N <= 128: two blocks an SM)
// and only a long one is squeezed to 64.  RESIDENCY_BUILD: four blocks an SM,
// 128 registers, the rest spilled.  A probe build exists for N <= 128 without
// storage, of the register build (both geometries), of the latency build
// (trapezoid geometry) and of the residency, the bracket and the lean builds
// (table geometry).  Table geometry
// (table) has the register, residency, bracket and lean builds: the latency
// build's closures are the trapezoid's own.  LONG_BUILD: 1024 threads, no
// dynamic shared memory, every shape, no probe build.  CLUSTER_BUILD: its
// cluster (cluster_blocks_for), rank_nodes threads and CLUSTER_DOUBLES_PER_NODE
// doubles of shared memory a rank node, every shape; a probe build of
// trapezoid geometry without storage.  REACH_BUILD: its cluster
// (REACH_RANKS blocks), reach_lanes * rank_nodes threads and
// REACH_DOUBLES_PER_NODE doubles of shared memory a rank node, every shape;
// a probe build of trapezoid geometry without storage.
int pick_build(int n, bool storage, bool table, int build, bool probe, Build* out) {
    if (build == REACH_BUILD) {
        const int rn = rank_nodes(n, REACH_RANKS), ln = reach_lanes(n);
        if (probe && (storage || table)) return (int)cudaErrorInvalidValue;
        *out = Build{reach_kernel(storage, table, probe, ln), ln * rn,
                     (size_t)REACH_DOUBLES_PER_NODE * rn * sizeof(double), REACH_RANKS};
        return 0;
    }
    if (build == LONG_BUILD) {
        if (probe) return (int)cudaErrorInvalidValue;
        *out = Build{long_build(storage, table), LONG_BLOCK, 0};
        return 0;
    }
    if (build == CLUSTER_BUILD) {
        if (probe && (storage || table)) return (int)cudaErrorInvalidValue;
        const int c = cluster_blocks_for(n), rn = rank_nodes(n, c);
        *out = Build{probe ? &fused_cluster_kernel<false, false, true> : cluster_build(storage, table), rn,
                     (size_t)CLUSTER_DOUBLES_PER_NODE * rn * sizeof(double), c};
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
    if (build == BRACKET_BUILD) {
        if (!small || !table) return (int)cudaErrorInvalidValue;
        *out = Build{probe ? &fused_bracket_kernel<true> : &fused_bracket_kernel<false>, threads_for(n),
                     (size_t)BRACKET_DOUBLES_PER_NODE * n * sizeof(double) + (size_t)n * sizeof(int)};
        return 0;
    }
    if (build == LEAN_BUILD) {
        if (!small || !table) return (int)cudaErrorInvalidValue;
        *out = Build{probe ? &fused_bracket_kernel<true, true> : &fused_bracket_kernel<false, true>, threads_for(n),
                     (size_t)LEAN_DOUBLES_PER_NODE * n * sizeof(double) + (size_t)n * sizeof(int)};
        return 0;
    }
    if (probe && (!small || !(build == REGISTER_BUILD || (table && build == RESIDENCY_BUILD))))
        return (int)cudaErrorInvalidValue;
    out->threads = threads_for(n);
    out->smem = smem_for(n);
    if (build == RESIDENCY_BUILD) {
        if (!small) return (int)cudaErrorInvalidValue;
        if (probe) out->fn = &fused_simulate_kernel<128, false, 4, true, true>;
        else out->fn = table ? &fused_simulate_kernel<128, false, 4, false, true>
                             : &fused_simulate_kernel<128, false, 4, false, false>;
        return 0;
    }
    if (build != REGISTER_BUILD) return (int)cudaErrorInvalidValue;
    if (probe) out->fn = table ? &fused_simulate_kernel<128, false, 1, true, true>
                               : &fused_simulate_kernel<128, false, 1, true, false>;
    else out->fn = table ? register_build_for<true>(n, storage) : register_build_for<false>(n, storage);
    return 0;
}

// The kernel's attributes a launch of the build needs: its dynamic shared
// memory and, above 8 blocks a cluster, a non-portable cluster size.  A
// block beyond the card's shared memory is refused here.
int prepare(const Build& b) {
    cudaError_t e = cudaFuncSetAttribute((const void*)b.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)b.smem);
    if (e == cudaSuccess && b.cluster > 8)
        e = cudaFuncSetAttribute((const void*)b.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return (int)e;
}

// blocks of this build the occupancy calculator puts on one SM
int resident_blocks(const Build& b, int* blocks) {
    const int rc = prepare(b);
    if (rc) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, (const void*)b.fn, b.threads, b.smem);
}

// A launch configuration of the build on `grid` blocks; attr receives the
// cluster dimension of the cluster build.
cudaLaunchConfig_t config_of(const Build& b, int grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(b.threads);
    cfg.dynamicSmemBytes = b.smem;
    cfg.stream = stream;
    if (b.cluster > 1) {
        attr->id = cudaLaunchAttributeClusterDimension;
        attr->val.clusterDim.x = b.cluster;
        attr->val.clusterDim.y = 1;
        attr->val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    return cfg;
}

// clusters of the cluster build the card holds at once
int active_clusters(const Build& b, int* clusters) {
    const int rc = prepare(b);
    if (rc) return rc;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_of(b, b.cluster, nullptr, &attr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)b.fn, &cfg);
}

// The grid of a launch of n_sims simulations: a block a simulation (the
// long build's each with its own scratch); the cluster build the blocks of
// as many clusters as the card holds at once, at most one a simulation; the
// reach build a cluster a simulation (both: cudaErrorLaunchOutOfResources
// when the card holds no cluster).
int grid_of(const Build& b, int build, int n_sims, int* grid) {
    *grid = n_sims;
    int rc, clusters;
    if (build == CLUSTER_BUILD || build == REACH_BUILD) {
        if ((rc = active_clusters(b, &clusters))) return rc;
        if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
        *grid = (build == REACH_BUILD || n_sims < clusters ? n_sims : clusters) * b.cluster;
    }
    return 0;
}

// The build a launch of n_sims simulations takes (fused_newton.chosen_build
// asks it through flowsim_fused_chosen_build): at N > REGISTER_MAX_N the
// reach build for one simulation and the cluster build for a batch (a card
// that cannot hold one of their clusters refuses the launch: grid_of); at N <= 128 without storage the latency
// build (table geometry: the lean build) while the batch fits the card in
// one wave of it, then the register build while it fits in one wave of
// that, then the residency build (table geometry: the bracket build) where
// it holds more members; every other shape the register build.
int choose_build_id(int n_sims, int n, bool storage, bool table, int* build) {
    *build = REGISTER_BUILD;
    int dev, sms, first_bps, reg_bps, res_bps, rc;
    Build b;
    if (n > REGISTER_MAX_N) {
        *build = n_sims == 1 ? REACH_BUILD : CLUSTER_BUILD;
        return 0;
    }
    if (n > LATENCY_MAX_N || storage) return 0;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
    const int first = table ? LEAN_BUILD : LATENCY_BUILD;
    if ((rc = pick_build(n, false, table, first, false, &b)) || (rc = resident_blocks(b, &first_bps))) return rc;
    if (n_sims <= first_bps * sms) { *build = first; return 0; }
    if ((rc = pick_build(n, false, table, REGISTER_BUILD, false, &b)) || (rc = resident_blocks(b, &reg_bps)))
        return rc;
    if (n_sims <= reg_bps * sms) return 0;
    const int many = table ? BRACKET_BUILD : RESIDENCY_BUILD;
    if ((rc = pick_build(n, false, table, many, false, &b)) || (rc = resident_blocks(b, &res_bps))) return rc;
    if (res_bps > reg_bps) *build = many;
    return 0;
}

// The build (build -1: choose_build_id), the kernel and the grid of a launch,
// with the kernel's attributes set.
int plan_launch(int n_sims, int n, bool storage, bool table, bool probe, int* build, Build* b, int* grid) {
    int rc;
    if (*build < 0 && (rc = choose_build_id(n_sims, n, storage, table, build))) return rc;
    if ((rc = pick_build(n, storage, table, *build, probe, b))) return rc;
    if ((rc = prepare(*b))) return rc;
    return grid_of(*b, *build, n_sims, grid);
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
extern "C" int flowsim_fused_bracket_bytes_per_node() {
    return BRACKET_DOUBLES_PER_NODE * (int)sizeof(double) + (int)sizeof(int);
}
extern "C" int flowsim_fused_lean_bytes_per_node() {
    return LEAN_DOUBLES_PER_NODE * (int)sizeof(double) + (int)sizeof(int);
}
extern "C" int flowsim_fused_cluster_block() { return CLUSTER_BLOCK; }
extern "C" int flowsim_fused_cluster_bytes_per_node() { return CLUSTER_DOUBLES_PER_NODE * (int)sizeof(double); }
extern "C" int flowsim_fused_max_cluster() { return MAX_LONG_CLUSTER; }
extern "C" int flowsim_fused_reach_bytes_per_node() { return REACH_DOUBLES_PER_NODE * (int)sizeof(double); }
extern "C" int flowsim_fused_reach_ranks() { return REACH_RANKS; }
// The closures' lanes a node of the reach build at N nodes (the rule's one
// home: fused_newton.reach_lanes asks it); 0 outside 2 <= N <= LONG_MAX_N.
extern "C" int flowsim_fused_reach_lanes(int n) { return n > 1 && n <= LONG_MAX_N ? reach_lanes(n) : 0; }

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

// build -1: choose_build_id; else that build (a test hook).  The long
// build needs the scratch [n_sims, LONG_DOUBLES_PER_NODE, N].
int launch(int build, bool probe, long long* probe_out, FLOWSIM_SIM_PARAMS, void* stream) {
    int rc = check_args(n_sims, n, nt, qlat_mode, qlat, st, stage, stor, stab, tab_shared, tab_k, tab_neq, tab_dk,
                        tab_m);
    if (rc) return rc;
    const bool storage = (st[0] | st[1]) & ST_ON;
    const bool table = tab_m != 0;
    Build b;
    int grid;
    if ((rc = plan_launch(n_sims, n, storage, table, probe, &build, &b, &grid))) return rc;
    if (build == LONG_BUILD && scratch == nullptr) return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_of(b, grid, (cudaStream_t)stream, &attr);
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, b.fn, (const double*)geo, (const double*)h0, (const double*)Q0, (const double*)us,
        (const double*)ds, (const double*)par, (const double*)qlat, (double*)depth, (double*)flow,
        (int*)iters, (double*)err, (int*)conv, (double*)gate, (double*)stage, (const double*)stor,
        (const double*)stab, stab_stride, n, nt, max_iter, pcr::n_sweeps(n), us_kind, ds_kind,
        rc_kind, us_rc_kind, store_boundaries, qlat_mode, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        (const double*)tab_shared, (const double*)tab_k, (const double*)tab_neq, (const double*)tab_dk, tab_m,
        probe_out, (double*)scratch, n_sims);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// One block per simulation: n_sims = 1 is fused_simulate, n_sims = B is
// fused_simulate_batched (the cluster build: a cluster per simulation up to
// the clusters the card holds at once).  Every array carries a
// leading n_sims axis (the storage tables only when stab_stride != 0).  st:
// the eight storage ints {us flags, ds flags, us nv, us na, ds nv, ds na, us
// nr, ds nr} (nr: the doubles of a poly_n or table outflow rating after the
// end's tables); stage [n_sims, nt, 2] is filled with NaN by the caller.
// tab_m: 0 for trapezoid geometry (geo [n_sims, 13, N]); M for table
// geometry (geo [n_sims, 4, N]: bed level, table span, bed slope,
// curvature), with tab_shared [4, N, M] (A, P, T, dR/dA) and tab_k, tab_neq,
// tab_dk [n_sims, N, M] (K, n_eq, dK/dA).  scratch: [n_sims,
// LONG_DOUBLES_PER_NODE, N] doubles for the long build (null otherwise).
// build: -1 chooses by the shape, the geometry and the member count
// (choose_build_id: what the wrappers do); 0-7 forces a build, so that chip_smoke.py can time the builds against each
// other and hold them to one another's bits.
extern "C" int flowsim_fused_simulate(FLOWSIM_SIM_PARAMS, int build, void* stream) {
    return launch(build, false, nullptr, FLOWSIM_SIM_ARGS, stream);
}

// The probe build of the register build, of the latency build (trapezoid
// geometry) or of the residency, the bracket or the lean build (table
// geometry) at N <= 128 without storage (build -1: the one the C entry
// chooses), or of the cluster or the reach build (trapezoid geometry without
// storage, any N): the same launch, and the cycles of each phase of thread 0 of block 0 summed over the run into
// probe [PH_COUNT] (device memory); clock_khz receives the SM clock rate the
// cycles count at.
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

// What flowsim_fused_simulate (probe 0) or flowsim_fused_simulate_probe
// (probe 1) launches for n_sims simulations of N nodes in `build` (-1: the
// C entry's choice): the build (out_build), its grid and the blocks of its
// cluster (1 outside the cluster build).  Refused, as the launch would be,
// with the CUDA error of the refusal: cudaErrorInvalidValue where the build
// does not take the shape, the geometry or the probe.
extern "C" int flowsim_fused_plan(int n_sims, int n, int storage, int table, int build, int probe, int* out_build,
                                  int* grid, int* cluster) {
    if (n_sims <= 0 || n <= 1 || n > LONG_MAX_N || out_build == nullptr || grid == nullptr || cluster == nullptr)
        return (int)cudaErrorInvalidValue;
    Build b;
    *out_build = build;
    *cluster = build == CLUSTER_BUILD ? cluster_blocks_for(n) : build == REACH_BUILD ? REACH_RANKS : 1;
    const int rc = plan_launch(n_sims, n, storage != 0, table != 0, probe != 0, out_build, &b, grid);
    if (!rc) *cluster = b.cluster;
    return rc;
}
