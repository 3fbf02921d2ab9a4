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
//  * one thread per node; h, Q and the linear system live in shared memory
//    for the whole run, the geometry and the previous level's state in
//    registers; device memory is touched only to read the inputs once and to
//    write each finished level;
//  * the level loop and the Newton loop are loops inside the block, so the
//    whole simulation is one launch (no per-iteration launch or host sync);
//  * neighbour values travel through shared memory; the assembly writes the
//    block rows straight into the PCR buffer; the solve is the shared
//    pcr_common.cuh sweep, ping-ponging two buffers (an in-place sweep
//    races), one barrier per sweep;
//  * the second PCR buffer doubles as the neighbour-exchange area during
//    assembly, which keeps the footprint at 30 doubles (240 B) per node and
//    lets N <= 964 fit the 227 KB of one SM;
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
// The TPU kernel instead inverts a monotone stage grid with a sign count and
// one-hot masks and resamples the tables to a 1024-point grid: a workaround
// for a vector unit without loops or gathers, not carried over.  The storage
// row is a separate, non-inlined device function fed from its own parameter
// block ([S, 2, SP_COUNT], upstream then downstream) by the boundary thread
// alone, and the carried reservoir stage lives in the output array
// ([S, nt, 2]: the stage of level k-1 is read back by the thread that wrote
// it), so the other threads hold no storage state in registers.
//
// Everything is float64 (native on this card): no double-single pairs and no
// f32 Jacobian as on the TPU.  The arithmetic mirrors ops/sections.py,
// ops/hydraulics.py, ops/rating_curve.py, ops/boundary.py and
// ops/preissmann.py expression for expression (cbrt + one Newton polish and
// sqrt for the fractional powers, the same guards and clamps, centered
// rating-curve basis, central-difference dQ/dz); built with --fmad=false the
// trajectory matches the plain PyTorch engine to rounding.
//
// Members in flight.  As a batch the flagship's 128-thread blocks are
// limited by registers, not shared memory (30 doubles a node, 29 KB a
// block).  The register build takes 250 registers with no spills, two
// blocks an SM, 264 members on the card.  A batch larger than that takes the
// residency build, __launch_bounds__(128, 4): 128 registers with a few
// hundred bytes spilled, four blocks an SM, 528 members in flight, the same
// arithmetic and the same bits (choose_build picks it by the member count
// from the occupancy calculator; a single simulation keeps the register
// build).  Five or six blocks an SM ran no faster, and neither did keeping
// the geometry and the previous level's state in shared memory to spill
// less: at four blocks the SM's issue and shared-memory traffic, not
// latency, set the pace.
//
// Reached on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py):
// 15.2 us per Newton iteration at N = 121 (the flagship: 73.1 ms for 4803
// iterations) and 45 us at N = 964 (the 1024-thread build, 64 registers,
// spilling); 10 240 flagship members, nodes 0 and N-1 stored, about 2.0 s
// in the residency build against 2.84 s in the register build.  With a
// lumped storage the boundary thread's bisection sets the pace: the 21-node
// reservoir example runs at 40 us per iteration (3.5 ms for 87).  The probe
// build splits the flagship's 14.9 us: closures 8.5, assembly 1.7, seven
// sweeps 4.2, back-substitution and update 0.2, level start 0.4.  PERF.md
// keeps the readings.
//
// C interface (ctypes): launches on the given stream, allocates nothing,
// does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>

#include "pcr_common.cuh"
#include "reach_common.cuh"

namespace {

constexpr int COMP = pcr::components<1>();  // 14 components per node
constexpr int SMEM_DOUBLES_PER_NODE = 2 * COMP + 2;

// STORAGE selects the build with the lumped-storage rows: a run without
// storage takes the build that has no call to storage_row in it, so its
// register allocation is what it was before storage existed.  MINB is the
// number of blocks an SM must hold: the launch bound caps the registers at
// 65536 / (MINB * BLOCK), and what does not fit spills.  No build changes an
// operation, so every build gives the same bits.  PROBE: the probe build
// (reach_common.cuh, Probe) of the flagship's shape.
template <int BLOCK, bool STORAGE, int MINB, bool PROBE>
__global__ void __launch_bounds__(BLOCK, MINB)
fused_simulate_kernel(const double* __restrict__ geo_all,   // [S, 13, N]
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
                      long long* __restrict__ probe_out) {  // [PH_COUNT] cycles (probe build)
    extern __shared__ double smem[];
    __shared__ double warp_part[2][32];

    const size_t sim = blockIdx.x;
    const double* geo = geo_all + sim * (size_t)G_ROWS * n;
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

    Geo g{};
    double z1 = 0.0;  // bed level of node i+1
    if (node) {
        g.z = geo[G_ZBED * n + i];      g.b = geo[G_BMAIN * n + i];
        g.m = geo[G_MMAIN * n + i];     g.n = geo[G_NMAIN * n + i];
        g.compound = geo[G_COMPOUND * n + i] != 0.0;
        g.hbank = geo[G_HBANK * n + i]; g.bl = geo[G_BFPL * n + i];
        g.br = geo[G_BFPR * n + i];     g.mfp = geo[G_MFP * n + i];
        g.nl = geo[G_NLEFT * n + i];    g.nr = geo[G_NRIGHT * n + i];
        g.s0 = geo[G_BEDSLOPE * n + i]; g.curv = geo[G_CURV * n + i];
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
    // gate-controller state: identical in every thread
    double gate_open = par[P_GATE_INIT];
    double gate_cooldown = 0.0, gate_prev_time = -1.0;
    if (first) { iters[0] = 0; errs[0] = 0.0; conv[0] = 1; gate[0] = gate_open; }
    __syncthreads();
    Probe<PROBE> probe;
    probe.start();
    double gate_stage = ds_bc.bed_level + sh[n - 1];

    const double th_dx = theta / dx;
    const double inv2dt = 1.0 / (2.0 * dt);

#define TDIFF(c1, c0, p1, p0) (((c1) + (c0) - (p1) - (p0)) / (2.0 * dt))
#define SDIFF(c1, c0, p1, p0) ((theta * ((c1) - (c0)) + (1.0 - theta) * ((p1) - (p0))) / dx)
#define CAVG(c1, c0, p1, p0) (0.5 * theta * ((c1) + (c0)) + 0.5 * (1.0 - theta) * ((p1) + (p0)))

    for (int k = 1; k < nt; ++k) {
        // -- once per level, before Newton: gate controller on the PREVIOUS
        //    level's downstream stage
        if (gated) {
            const double time = (double)k * dt;
            const double elapsed = gate_prev_time >= 0.0 ? time - gate_prev_time : 0.0;
            gate_cooldown = clamp_min(gate_cooldown - elapsed, 0.0);
            const bool can_act = gate_cooldown <= 0.0;
            const bool do_open = can_act && (gate_stage >= rat.pivot + 0.5) && (gate_open < 0.5);
            const bool do_close = can_act && (gate_stage <= rat.pivot - 1.0) && (gate_open > 0.5);
            gate_open = do_open ? 1.0 : (do_close ? 0.0 : gate_open);
            gate_cooldown = (do_open || do_close) ? rat.cooldown : gate_cooldown;
            gate_prev_time = time;
        }

        // -- previous-level state, own node and node i+1
        double hp0 = 0, Qp0 = 0, Ap0 = 0, Sep0 = 0, Q2Ap0 = 0;
        double hp1 = 0, Qp1 = 0, Ap1 = 0, Sep1 = 0, Q2Ap1 = 0;
        if (node) {
            hp0 = sh[i]; Qp0 = sQ[i];
            const Sec s = section_state(g, hp0);
            const Slope e = energy_slope(g, s, hp0, Qp0);
            Ap0 = s.A; Sep0 = e.Se; Q2Ap0 = Qp0 * Qp0 / s.A;
            buf1[0 * n + i] = Ap0; buf1[1 * n + i] = Sep0; buf1[2 * n + i] = Q2Ap0;
        }
        __syncthreads();
        probe.mark(PH_LEVEL);
        if (cell) {
            hp1 = sh[i + 1]; Qp1 = sQ[i + 1];
            Ap1 = buf1[0 * n + i + 1]; Sep1 = buf1[1 * n + i + 1]; Q2Ap1 = buf1[2 * n + i + 1];
        }
        const double us_target = us_series[k], ds_target = ds_series[k];
        // lateral inflow of this level: the theta-weighted cell average
        double qavg = 0.0;
        if (cell && qlat_mode != QLAT_NONE) {
            const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * n : qlat;
            const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * n : qlat;
            qavg = CAVG(qc[i + 1], qc[i], qp[i + 1], qp[i]);
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
                const double A1 = buf1[0 * n + j], Q2A1 = buf1[1 * n + j], Se1 = buf1[2 * n + j];
                const double dA_dh1 = buf1[3 * n + j], dSe_dA1 = buf1[4 * n + j];
                const double dSe_dQ1 = buf1[5 * n + j], QA1 = buf1[6 * n + j];
                const double h1 = sh[j], Q1 = sQ[j];
                const double A0 = s.A, Se0 = e.Se, dA_dh0 = s.dA_dh;
                const double dSe_dA0 = e.dSe_dA, dSe_dQ0 = e.dSe_dQ;

                double Rc = TDIFF(A1, A0, Ap1, Ap0) + SDIFF(Q1, Q, Qp1, Qp0);
                if (qlat_mode != QLAT_NONE) Rc = Rc - qavg;
                const double avgA = CAVG(A1, A0, Ap1, Ap0);
                const double dYdx = (z1 - g.z) / dx + SDIFF(h1, h, hp1, hp0);
                const double avgSe = CAVG(Se1, Se0, Sep1, Sep0);
                const double Rm = TDIFF(Q1, Q, Qp1, Qp0) + SDIFF(Q2A1, Q2A0, Q2Ap1, Q2Ap0)
                    + G * avgA * (dYdx + avgSe);
                const double geom = dYdx + avgSe;

                const double dC_dh_i = dA_dh0 * inv2dt;
                const double dC_dh_i1 = dA_dh1 * inv2dt;
                const double dM_dh_i = (th_dx * (QA0 * QA0) * dA_dh0
                    + G * (avgA * (-th_dx + 0.5 * theta * dSe_dA0 * dA_dh0)
                           + 0.5 * theta * dA_dh0 * geom));
                const double dM_dh_i1 = (-th_dx * (QA1 * QA1) * dA_dh1
                    + G * (avgA * (th_dx + 0.5 * theta * dSe_dA1 * dA_dh1)
                           + 0.5 * theta * dA_dh1 * geom));
                const double dM_dQ_i = inv2dt - th_dx * 2.0 * QA0 + G * avgA * 0.5 * theta * dSe_dQ0;
                const double dM_dQ_i1 = inv2dt + th_dx * 2.0 * QA1 + G * avgA * 0.5 * theta * dSe_dQ1;

                // node i, row 1: continuity of cell i
                buf0[6 * n + i] = dC_dh_i;   buf0[7 * n + i] = -th_dx;
                buf0[10 * n + i] = dC_dh_i1; buf0[11 * n + i] = th_dx;
                buf0[13 * n + i] = -Rc;
                // node i+1, row 0: momentum of cell i
                buf0[0 * n + j] = dM_dh_i;   buf0[1 * n + j] = dM_dQ_i;
                buf0[4 * n + j] = dM_dh_i1;  buf0[5 * n + j] = dM_dQ_i1;
                buf0[12 * n + j] = -Rm;
                sq = Rc * Rc + Rm * Rm;
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
                    const double Y_old = k == 1 ? hp0 + us_bc.bed_level : stage[(size_t)(k - 1) * 2 + 1];
                    res = storage_row(stor_all + sim * (size_t)(2 * SP_COUNT),
                                      stab_all + sim * (size_t)stab_stride, us_sflags, us_nv, us_na,
                                      -1.0, us_bc.bed_level, dt, Qp0, Y_old, s.A, s.R, s.n_eq, s.dR_dA,
                                      s.dA_dh, h, Q, &buf0[4 * n + i], &buf0[5 * n + i],
                                      &buf0[12 * n + i], &stage[(size_t)k * 2 + 1]);
                    // with no downstream storage the upstream stage is the run's reservoir_stage
                    if (!ds_stor) stage[(size_t)k * 2] = stage[(size_t)k * 2 + 1];
                } else {
                    boundary_row(us_bc, us_rat, s, h, Q, us_target, gate_open, res, df_dh, df_dQ);
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
                                      stab_all + sim * (size_t)stab_stride + 2 * (us_nv + us_na),
                                      ds_sflags, ds_nv, ds_na, 1.0, ds_bc.bed_level, dt, Qp0, Y_old,
                                      s.A, s.R, s.n_eq, s.dR_dA, s.dA_dh, h, Q, &buf0[6 * n + i],
                                      &buf0[7 * n + i], &buf0[13 * n + i], &stage[(size_t)k * 2]);
                } else {
                    boundary_row(ds_bc, rat, s, h, Q, ds_target, gate_open, res, df_dh, df_dQ);
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
            gate[k] = gate_open;
        }
    }
    probe.write(probe_out);
#undef TDIFF
#undef SDIFF
#undef CAVG
#undef STORE_LEVEL
}

// Every build has one signature: a build is a kernel pointer.
using KernelFn = decltype(&fused_simulate_kernel<128, false, 1, false>);

enum { REGISTER_BUILD = 0, RESIDENCY_BUILD = 1 };

template <int BLOCK>
KernelFn register_build(bool storage) {
    return storage ? &fused_simulate_kernel<BLOCK, true, 1, false> : &fused_simulate_kernel<BLOCK, false, 1, false>;
}

// REGISTER_BUILD: the block size alone is the launch bound, so a small reach
// gets the full register budget (250 registers at N <= 128: two blocks an SM)
// and only a long one is squeezed to 64.  RESIDENCY_BUILD (N <= 128 without
// storage only): four blocks an SM, 128 registers, the rest spilled.
int pick_build(int n, bool storage, int build, KernelFn* out) {
    if (build == RESIDENCY_BUILD) {
        if (n > 128 || storage) return (int)cudaErrorInvalidValue;
        *out = &fused_simulate_kernel<128, false, 4, false>;
        return 0;
    }
    if (build != REGISTER_BUILD) return (int)cudaErrorInvalidValue;
    if (n <= 128) *out = register_build<128>(storage);
    else if (n <= 256) *out = register_build<256>(storage);
    else if (n <= 512) *out = register_build<512>(storage);
    else *out = register_build<1024>(storage);
    return 0;
}

int threads_for(int n) { return ((n + 31) / 32) * 32; }
size_t smem_for(int n) { return (size_t)SMEM_DOUBLES_PER_NODE * n * sizeof(double); }

// blocks of this build the occupancy calculator puts on one SM
int resident_blocks(KernelFn fn, int n, int* blocks) {
    cudaError_t e = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_for(n));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, (const void*)fn, threads_for(n),
                                                              smem_for(n));
}

// The build a launch of n_sims simulations takes: the register build is the
// faster per member, so it runs every batch the card holds at once; a larger
// batch takes the residency build when that holds more members.
int choose_build(int n_sims, int n, bool storage, KernelFn* out) {
    int rc = pick_build(n, storage, REGISTER_BUILD, out);
    if (rc || n > 128 || storage) return rc;
    int dev, sms, regs_bps, res_bps;
    KernelFn res;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
    if (n_sims <= sms) return 0;
    if ((rc = resident_blocks(*out, n, &regs_bps))) return rc;
    if ((rc = pick_build(n, false, RESIDENCY_BUILD, &res))) return rc;
    if ((rc = resident_blocks(res, n, &res_bps))) return rc;
    if (n_sims > regs_bps * sms && res_bps > regs_bps) *out = res;
    return 0;
}

}  // namespace

extern "C" int flowsim_fused_param_count() { return P_COUNT; }
extern "C" int flowsim_fused_probe_phases() { return PH_COUNT; }
extern "C" int flowsim_fused_smem_bytes_per_node() { return SMEM_DOUBLES_PER_NODE * (int)sizeof(double); }
extern "C" int flowsim_fused_storage_param_count() { return SP_COUNT; }

#define FLOWSIM_SIM_PARAMS const void* geo, const void* h0, const void* Q0, const void* us, const void* ds, \
        const void* par, const void* qlat, void* depth, void* flow, void* iters, void* err, void* conv, \
        void* gate, void* stage, const void* stor, const void* stab, long long stab_stride, int n_sims, int n, \
        int nt, int max_iter, int us_kind, int ds_kind, int rc_kind, int us_rc_kind, int store_boundaries, \
        int qlat_mode, const int* st
#define FLOWSIM_SIM_ARGS geo, h0, Q0, us, ds, par, qlat, depth, flow, iters, err, conv, gate, stage, stor, stab, \
        stab_stride, n_sims, n, nt, max_iter, us_kind, ds_kind, rc_kind, us_rc_kind, store_boundaries, qlat_mode, st

namespace {

int check_args(int n_sims, int n, int nt, int qlat_mode, const void* qlat, const int* st, const void* stage,
               const void* stor, const void* stab) {
    if (n_sims <= 0 || n <= 1 || n > 1024 || nt <= 0) return (int)cudaErrorInvalidValue;
    if (qlat_mode < QLAT_NONE || qlat_mode > QLAT_LEVELS) return (int)cudaErrorInvalidValue;
    if ((qlat_mode != QLAT_NONE) != (qlat != nullptr)) return (int)cudaErrorInvalidValue;
    if (st == nullptr || stage == nullptr) return (int)cudaErrorInvalidValue;
    if (((st[0] | st[1]) & ST_ON) && stor == nullptr) return (int)cudaErrorInvalidValue;
    if (((st[0] | st[1]) & ST_AREA_CURVE) && stab == nullptr) return (int)cudaErrorInvalidValue;
    return 0;
}

int run(KernelFn fn, long long* probe, FLOWSIM_SIM_PARAMS, void* stream) {
    const size_t smem = smem_for(n);
    cudaError_t e = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    fn<<<n_sims, threads_for(n), smem, (cudaStream_t)stream>>>(
        (const double*)geo, (const double*)h0, (const double*)Q0, (const double*)us,
        (const double*)ds, (const double*)par, (const double*)qlat, (double*)depth, (double*)flow,
        (int*)iters, (double*)err, (int*)conv, (double*)gate, (double*)stage, (const double*)stor,
        (const double*)stab, stab_stride, n, nt, max_iter, pcr::n_sweeps(n), us_kind, ds_kind,
        rc_kind, us_rc_kind, store_boundaries, qlat_mode, st[0], st[1], st[2], st[3], st[4], st[5], probe);
    return (int)cudaGetLastError();
}

}  // namespace

// One block per simulation: n_sims = 1 is fused_simulate, n_sims = B is
// fused_simulate_batched.  Every array carries a leading n_sims axis (the
// storage tables only when stab_stride != 0).  st: the six storage ints
// {us flags, ds flags, us nv, us na, ds nv, ds na}; stage [n_sims, nt, 2] is
// filled with NaN by the caller.  build: -1 chooses by the member count
// (choose_build: what the wrappers do); 0 or 1 forces a build, so that
// chip_smoke.py can time the two against each other.
extern "C" int flowsim_fused_simulate(FLOWSIM_SIM_PARAMS, int build, void* stream) {
    int rc = check_args(n_sims, n, nt, qlat_mode, qlat, st, stage, stor, stab);
    if (rc) return rc;
    const bool storage = (st[0] | st[1]) & ST_ON;
    KernelFn fn;
    rc = build < 0 ? choose_build(n_sims, n, storage, &fn) : pick_build(n, storage, build, &fn);
    return rc ? rc : run(fn, nullptr, FLOWSIM_SIM_ARGS, stream);
}

// The probe build of the register build at N <= 128 without storage (the
// flagship's shape): the same launch, and the cycles of each phase of thread
// 0 of block 0 summed over the run into probe [PH_COUNT] (device memory);
// clock_khz receives the SM clock rate the cycles count at.
extern "C" int flowsim_fused_simulate_probe(FLOWSIM_SIM_PARAMS, void* probe, int* clock_khz, void* stream) {
    int rc = check_args(n_sims, n, nt, qlat_mode, qlat, st, stage, stor, stab);
    if (rc) return rc;
    if (n > 128 || ((st[0] | st[1]) & ST_ON) || probe == nullptr || clock_khz == nullptr)
        return (int)cudaErrorInvalidValue;
    int dev;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, dev))) return rc;
    return run(&fused_simulate_kernel<128, false, 1, true>, (long long*)probe, FLOWSIM_SIM_ARGS, stream);
}
#undef FLOWSIM_SIM_PARAMS
#undef FLOWSIM_SIM_ARGS

// Resident blocks per SM of a build (0: the register build, 1: the residency
// build) at N nodes, from the CUDA occupancy calculator.
extern "C" int flowsim_fused_resident_blocks(int n, int storage, int build, int* blocks) {
    if (n <= 1 || n > 1024 || blocks == nullptr) return (int)cudaErrorInvalidValue;
    KernelFn fn;
    const int rc = pick_build(n, storage != 0, build, &fn);
    return rc ? rc : resident_blocks(fn, n, blocks);
}
