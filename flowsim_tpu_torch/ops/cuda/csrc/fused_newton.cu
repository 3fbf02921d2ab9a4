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
// Reached on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py):
// 15.2 us per Newton iteration at N = 121 (the flagship: 73.1 ms for 4803
// iterations, 250 registers, no spills) and 45 us at N = 964 (the 1024-thread
// build, 64 registers, spilling).  As a batch the flagship's 128-thread blocks
// are resident two to an SM (registers), 264 on the card: 132 members take
// 81 ms, 264 take 91 ms, and beyond that the time grows with the member count
// (10 240 members, nodes 0 and N-1 stored: 2.85 s, 12.6 times the bound by
// FP64 operations).  With a lumped storage the boundary thread's bisection
// sets the pace: the 21-node reservoir example runs at 40 us per iteration
// (3.5 ms for 87).  PERF.md keeps the readings.
//
// C interface (ctypes): launches on the given stream, allocates nothing,
// does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>

#include "pcr_common.cuh"

namespace {

constexpr double G = 9.80665;

// rows of the packed geometry [13, N]
enum { G_ZBED, G_BMAIN, G_MMAIN, G_NMAIN, G_COMPOUND, G_HBANK, G_BFPL, G_BFPR, G_MFP,
       G_NLEFT, G_NRIGHT, G_BEDSLOPE, G_CURV, G_ROWS };

// slots of the packed scalar parameters
enum { P_THETA, P_DT, P_DX, P_TOL,
       P_US_BED_LEVEL, P_US_BED_SLOPE, P_US_INIT_DEPTH,
       P_DS_BED_LEVEL, P_DS_BED_SLOPE, P_DS_INIT_DEPTH,
       P_RC_LOW0, P_RC_LOW1, P_RC_LOW2, P_RC_HIGH0, P_RC_HIGH1, P_RC_HIGH2,
       P_RC_SHIFT, P_RC_PIVOT, P_RC_BUFFER, P_RC_FD, P_RC_COOLDOWN, P_GATE_INIT,
       // the upstream rating curve (polynomial or blended_poly; never gated)
       P_URC_LOW0, P_URC_LOW1, P_URC_LOW2, P_URC_HIGH0, P_URC_HIGH1, P_URC_HIGH2,
       P_URC_SHIFT, P_URC_PIVOT, P_URC_BUFFER, P_URC_FD, P_COUNT };

// slots of one boundary's storage block, [S, 2, SP_COUNT] (0: upstream, 1: downstream)
enum { SP_SURFACE_AREA, SP_MIN_STAGE, SP_Y_MIN, SP_Y_MAX, SP_BETA, SP_LRES, SP_KQ,
       SP_RC_LOW0, SP_RC_LOW1, SP_RC_LOW2, SP_RC_HIGH0, SP_RC_HIGH1, SP_RC_HIGH2,
       SP_RC_SHIFT, SP_RC_PIVOT, SP_RC_BUFFER, SP_RC_FD, SP_COUNT };
// bits of a boundary's storage flags; bits 4.. hold the storage rating's kind
enum { ST_ON = 1, ST_AREA_CURVE = 2, ST_RATING = 4, ST_LOSSES = 8, ST_RC_SHIFT = 4 };
constexpr int BISECT_ITERS = 80;          // ops/storage.py
constexpr double INTERP_EPS = 4.930380657631324e-32;  // spacing(eps), as jnp.interp guards dx

enum { BC_FLOW = 0, BC_STAGE = 1, BC_FIXED = 2, BC_NORMAL = 3, BC_RATING = 4 };
enum { RC_POLY = 0, RC_BLEND = 1, RC_GATED = 2 };
enum { QLAT_NONE = 0, QLAT_CONST = 1, QLAT_LEVELS = 2 };

constexpr int COMP = pcr::components<1>();  // 14 components per node
constexpr int SMEM_DOUBLES_PER_NODE = 2 * COMP + 2;

// torch.clamp semantics: NaN propagates (fmax/fmin would drop it)
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }
__device__ __forceinline__ double clamp01(double x) { return x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x); }

// -- ops/hydraulics.py ------------------------------------------------------

__device__ __forceinline__ double cbrt_polished(double x) {
    if (x == 0.0) return 0.0;
    const double r = cbrt(x);
    const double r2 = r * r;
    const double r3 = r2 * r;
    return r - (r3 - x) / (3.0 * r2);
}
__device__ __forceinline__ double pow_2_3(double x) { const double c = cbrt_polished(x); return c * c; }
__device__ __forceinline__ double pow_m1_3(double x) { return 1.0 / cbrt_polished(x); }
__device__ __forceinline__ double pow_1_6(double x) { return sqrt(cbrt_polished(x)); }
__device__ __forceinline__ double pow_3_2(double x) { return x > 0.0 ? x * sqrt(x) : 0.0; }

__device__ __forceinline__ double conveyance(double A, double n, double R) { return A * pow_2_3(R) / n; }
__device__ __forceinline__ double hyd_dK_dA(double A, double n, double R, double dR_dA) {
    return (pow_2_3(R) + A * (2.0 / 3.0) * pow_m1_3(R) * dR_dA) / n;
}
__device__ __forceinline__ double friction_slope(double Q, double K) { return Q * fabs(Q) / (K * K); }
__device__ __forceinline__ double hyd_dSf_dA(double Q, double K, double dK) {
    return -2.0 * friction_slope(Q, K) * (dK / K);
}
__device__ __forceinline__ double hyd_dSf_dQ(double Q, double K) { return 2.0 * fabs(Q) / (K * K); }
__device__ __forceinline__ double froude(double T, double A, double Q) {
    const double V = Q / clamp_min(A, 1e-6);
    const double D = A / clamp_min(T, 1e-6);
    return V / sqrt(G * clamp_min(D, 1e-6));
}
__device__ __forceinline__ double dFr_dA(double T, double A, double Q) {
    const double V = Q / A;
    const double D = A / T;
    const double dV_dA = -Q / (A * A);
    const double dD_dA = 1.0 / T;
    const double gD = G * D;
    const double inv_sqrt = 1.0 / sqrt(gD);
    return -0.5 * V * (inv_sqrt / gD) * G * dD_dA + dV_dA * inv_sqrt;
}
__device__ __forceinline__ double dFr_dQ(double T, double A) {
    const double D = A / T;
    return (1.0 / A) / sqrt(G * D);
}
__device__ __forceinline__ double darcy_f(double n, double R) {
    const double C = pow_1_6(R) / n;
    return (8.0 * G) / (C * C);
}
__device__ __forceinline__ double curvature_slope(double h, double T, double A, double Q,
                                                  double n, double R, double rc) {
    const double Fr = froude(T, A, Q);
    const double f = darcy_f(n, R);
    const double sqrtf_ = sqrt(f);
    const double num = (2.86 * sqrtf_ + 2.07 * f) * h * h * Fr * Fr;
    const double den = (0.565 + sqrtf_) * rc * rc;
    return num / den;
}
__device__ __forceinline__ double hyd_dSc_dA(double h, double A, double Q, double n, double R,
                                             double rc, double dR_dA, double T) {
    const double Fr = froude(T, A, Q);
    const double f = darcy_f(n, R);
    const double dh_dA = 1.0 / T;
    const double dFr = dFr_dA(T, A, Q);
    const double df_dA = (-(8.0 / 3.0) * G) * n * n * (pow_m1_3(R) / R) * dR_dA;
    const double sqrtf_ = sqrt(f);
    const double num = (2.86 * sqrtf_ + 2.07 * f) * h * h * Fr * Fr;
    const double den = (0.565 + sqrtf_) * rc * rc;
    const double dnum_dA = (2.86 / (2.0 * sqrtf_) * df_dA + 2.07 * df_dA) * h * h * Fr * Fr
        + (2.86 * sqrtf_ + 2.07 * f) * (2.0 * h * dh_dA * Fr * Fr + h * h * 2.0 * Fr * dFr);
    const double dden_dA = (1.0 / (2.0 * sqrtf_) * df_dA) * rc * rc;
    return (dnum_dA * den - num * dden_dA) / (den * den);
}
__device__ __forceinline__ double hyd_dSc_dQ(double h, double T, double A, double Q, double n,
                                             double R, double rc) {
    const double Fr = froude(T, A, Q);
    const double f = darcy_f(n, R);
    const double dFr = dFr_dQ(T, A);
    const double sqrtf_ = sqrt(f);
    const double den = (0.565 + sqrtf_) * rc * rc;
    const double dnum_dQ = (2.86 * sqrtf_ + 2.07 * f) * h * h * 2.0 * Fr * dFr;
    return dnum_dQ / den;
}

// -- ops/sections.py --------------------------------------------------------

struct Geo {
    double z, b, m, n, hbank, bl, br, mfp, nl, nr, s0, curv;
    bool compound;
};

struct Sec { double A, P, R, T, K, n_eq, dA_dh, dR_dA, dK_dA; };
struct Slope { double Se, dSe_dA, dSe_dQ; };

__device__ __forceinline__ double safe_div(double num, double den) { return den > 0.0 ? num / den : 0.0; }

__device__ Sec section_state(const Geo& g, double depth_in) {
    const double depth = clamp_min(depth_in, 0.0);
    const bool wet = depth > 0.0;
    const bool ob = g.compound && (depth > g.hbank);
    const double hb = g.compound ? g.hbank : 1.0;
    const double d_fp = ob ? depth - hb : 0.0;

    const double sq_m = sqrt(1.0 + g.m * g.m);
    const double sq_fp = sqrt(1.0 + g.mfp * g.mfp);

    const double T_s = g.b + 2.0 * g.m * depth;
    const double A_s = (g.b + g.m * depth) * depth;
    const double P_s = g.b + 2.0 * depth * sq_m;

    const double T_bank = g.b + 2.0 * g.m * hb;
    const double A_mf = (g.b + T_bank) / 2.0 * hb;
    const double P_mf = g.b + 2.0 * hb * sq_m;

    const double A_l = (g.bl + 0.5 * g.mfp * d_fp) * d_fp;
    const double P_l = g.bl + d_fp * sq_fp;
    const double A_r = (g.br + 0.5 * g.mfp * d_fp) * d_fp;
    const double P_r = g.br + d_fp * sq_fp;
    const double width_at_bank = g.bl + T_bank + g.br;

    Sec s;
    double A = ob ? A_mf + A_l + A_r : A_s;
    double P = ob ? P_mf + P_l + P_r : P_s;
    double T = ob ? width_at_bank + 2.0 * g.mfp * d_fp : T_s;
    if (!wet) { A = 0.0; P = 0.0; T = 0.0; }
    const double R = safe_div(A, P);

    // Horton-Einstein subsections: below bankfull the whole section is "main"
    const double A_m = ob ? A_mf + T_bank * d_fp : A;
    const double P_m = ob ? P_mf : P;
    const double R_m = safe_div(A_m, P_m);
    const double A_l2 = ob ? A_l : 0.0, P_l2 = ob ? P_l : 0.0;
    const double R_l = safe_div(A_l2, P_l2);
    const double A_r2 = ob ? A_r : 0.0, P_r2 = ob ? P_r : 0.0;
    const double R_r = safe_div(A_r2, P_r2);
    const double K_l = P_l2 > 0.0 ? conveyance(A_l2, g.nl, R_l) : 0.0;
    const double K_m = P_m > 0.0 ? conveyance(A_m, g.n, R_m) : 0.0;
    const double K_r = P_r2 > 0.0 ? conveyance(A_r2, g.nr, R_r) : 0.0;

    const double ksum = pow_3_2(K_l) + pow_3_2(K_m) + pow_3_2(K_r);
    const double K_compound = ksum > 0.0 ? pow_2_3(ksum) : 0.0;
    const double K_simple = conveyance(A, g.n, R);
    s.K = g.compound ? K_compound : K_simple;

    const double n_eq_c = (A > 0.0 && R > 0.0 && K_compound > 0.0)
        ? A * pow_2_3(R) / (K_compound > 0.0 ? K_compound : 1.0) : g.n;
    s.n_eq = g.compound ? n_eq_c : g.n;

    const double dP_dh = ob ? 2.0 * sq_fp : 2.0 * sq_m;
    const bool ok = (P > 0.0) && (T > 0.0);
    const double dP_dA = dP_dh / (ok ? T : 1.0);
    s.dR_dA = ok ? (P - A * dP_dA) / (P * P) : 0.0;
    s.dK_dA = A > 0.0 ? hyd_dK_dA(A, s.n_eq, R, s.dR_dA) : 0.0;
    s.A = A; s.P = P; s.R = R; s.T = T; s.dA_dh = T;
    return s;
}

__device__ Slope energy_slope(const Geo& g, const Sec& s, double h, double Q) {
    const bool Kpos = s.K > 0.0;
    const double Ksafe = Kpos ? s.K : 1.0;
    const double Sf = Kpos ? friction_slope(Q, Ksafe) : 0.0;
    const double dSf_dA = Kpos ? hyd_dSf_dA(Q, Ksafe, s.dK_dA) : 0.0;
    const double dSf_dQ = Kpos ? hyd_dSf_dQ(Q, Ksafe) : 0.0;

    const bool has_curv = g.curv != 0.0;
    const bool has_curv_d = fabs(g.curv) > 1e-12;
    const double rc = 1.0 / (has_curv ? g.curv : 1.0);
    const double Rsafe = s.R > 0.0 ? s.R : 1.0;

    const double Sc = has_curv ? curvature_slope(h, s.T, s.A, Q, s.n_eq, Rsafe, rc) : 0.0;
    const double dSc_dA = has_curv_d
        ? hyd_dSc_dA(h, s.A, Q, s.n_eq, Rsafe, rc, s.dR_dA, s.T) * s.dA_dh : 0.0;
    const double dSc_dQ = has_curv_d ? hyd_dSc_dQ(h, s.T, s.A, Q, s.n_eq, Rsafe, rc) : 0.0;

    Slope e;
    e.Se = Sf + Sc;
    e.dSe_dA = dSf_dA + dSc_dA;
    e.dSe_dQ = dSf_dQ + dSc_dQ;
    return e;
}

// -- ops/rating_curve.py ----------------------------------------------------

struct Rating {
    double low0, low1, low2, high0, high1, high2, shift, pivot, buffer, fd, cooldown;
    int kind;
};

__device__ __forceinline__ double quad(double c0, double c1, double c2, double x) {
    return (c0 * x + c1) * x + c2;
}

// Q(stage); gate_open is read by the gated kind only
__device__ __forceinline__ double rating_q(const Rating& r, double stage, double gate_open) {
    if (r.kind == RC_POLY) {
        const double x = stage + r.shift;
        return r.low0 * x * x + r.low1 * x + r.low2;
    }
    const double ds = stage - r.pivot;  // centered basis
    const double low = quad(r.low0, r.low1, r.low2, ds);
    const double high = quad(r.high0, r.high1, r.high2, ds);
    if (r.kind == RC_GATED) return gate_open > 0.5 ? high : low;
    double s = (stage - r.pivot) / clamp_min(r.buffer, 1e-30);
    s = clamp01(s);
    const double alpha = 3.0 * s * s - 2.0 * s * s * s;
    return low + alpha * (high - low);
}

__device__ __forceinline__ double rating_dq_dz(const Rating& r, double stage, double gate_open) {
    if (r.kind == RC_POLY) {
        const double x = stage + r.shift;
        return r.low0 * 2.0 * x + r.low1;
    }
    // central difference with the reference's step, not the analytic slope
    return (rating_q(r, stage + r.fd, gate_open) - rating_q(r, stage - r.fd, gate_open)) / (2.0 * r.fd);
}

// -- ops/storage.py ---------------------------------------------------------

// ops/storage.py::interp: linear interpolation, the end values held outside
__device__ __forceinline__ double interp_table(double x, const double* __restrict__ xp,
                                               const double* __restrict__ fp, int n) {
    // searchsorted(right=True): the number of entries <= x, by bisection
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (xp[mid] <= x) lo = mid + 1; else hi = mid;
    }
    const int i = lo < 1 ? 1 : (lo > n - 1 ? n - 1 : lo);
    const double df = fp[i] - fp[i - 1];
    const double dx = xp[i] - xp[i - 1];
    const double delta = x - xp[i - 1];
    double val = fabs(dx) <= INTERP_EPS ? fp[i - 1] : fp[i - 1] + (delta / dx) * df;
    if (x < xp[0]) val = fp[0];
    if (x > xp[n - 1]) val = fp[n - 1];
    return val;
}

__device__ __forceinline__ int sign_of(double x) { return (x > 0.0) - (x < 0.0); }

// The fixed_depth + storage boundary row (ops/boundary.py::evaluate, storage
// branch).  sp: this boundary's SP_* block; tab: its tables
// [vol_stage(nv) | vol_table(nv) | area_stage(na) | area_table(na)].
// Writes df_dh, df_dQ, -residual and the new stage where the caller points;
// returns the residual.  Not inlined: one thread of the block runs it, and
// its registers should not count against the other threads' budget.
__device__ __noinline__ double storage_row(const double* __restrict__ sp,
                                           const double* __restrict__ tab, int flags, int nv, int na,
                                           double sign, double bed_level, double dt, double Q_prev,
                                           double Y_old, double A, double R, double n_eq,
                                           double dR_dA, double dA_dh, double h, double Q,
                                           double* p_df_dh, double* p_df_dQ, double* p_neg_res,
                                           double* p_stage) {
    const bool curve = flags & ST_AREA_CURVE, rated = flags & ST_RATING, losses = flags & ST_LOSSES;
    const double* vol_stage = tab;
    const double* vol_table = tab + nv;
    const double* area_stage = tab + 2 * nv;
    const double* area_table = area_stage + na;
    const double SA = sp[SP_SURFACE_AREA], min_stage = sp[SP_MIN_STAGE];
    Rating rat{};
    if (rated)
        rat = Rating{sp[SP_RC_LOW0], sp[SP_RC_LOW1], sp[SP_RC_LOW2], sp[SP_RC_HIGH0], sp[SP_RC_HIGH1],
                     sp[SP_RC_HIGH2], sp[SP_RC_SHIFT], sp[SP_RC_PIVOT], sp[SP_RC_BUFFER], sp[SP_RC_FD],
                     0.0, flags >> ST_RC_SHIFT};

    const double vol_in = sign * 0.5 * (Q_prev + Q) * dt;

    // mass_balance: 80 halvings of [y_min, y_max] on
    //   g(Y) = net_vol_change(Y_old, Y) - (vol_in - 0.5 (q(Y_old) + q(Y)) dt)
    const double v_old = curve ? interp_table(Y_old, vol_stage, vol_table, nv) : 0.0;
    const double q_old = rated ? rating_q(rat, Y_old, 0.0) : 0.0;
    auto g_of = [&](double Y) {
        const double q_new = rated ? rating_q(rat, Y, 0.0) : 0.0;
        const double target_vol = vol_in - 0.5 * (q_old + q_new) * dt;
        const double dv = curve ? interp_table(Y, vol_stage, vol_table, nv) - v_old : (Y - Y_old) * SA;
        return dv - target_vol;
    };
    double lo = sp[SP_Y_MIN], hi = sp[SP_Y_MAX];
    double f_lo = g_of(lo);
    for (int b = 0; b < BISECT_ITERS; ++b) {
        const double mid = 0.5 * (lo + hi);
        const double f_mid = g_of(mid);
        // torch.sign(f_mid) == torch.sign(f_lo): false when either is NaN
        const bool go_right = f_mid == f_mid && f_lo == f_lo && sign_of(f_mid) == sign_of(f_lo);
        if (go_right) { lo = mid; f_lo = f_mid; } else { hi = mid; }
    }
    double Y_new = 0.5 * (lo + hi);
    if (Y_new < min_stage) Y_new = min_stage;

    // entrance losses: friction over the reservoir length + K_q V^2 / 2g
    double head_loss = 0.0, d_hl_dA = 0.0, d_hl_dQ = 0.0;
    if (losses) {
        const double Lres = sp[SP_LRES], K_q = sp[SP_KQ];
        const double K = conveyance(A, n_eq, R);
        const double dK = hyd_dK_dA(A, n_eq, R, dR_dA);
        const double V = Q / A;
        head_loss = friction_slope(Q, K) * Lres + K_q * V * V / (2.0 * G);
        const double dV_dA = -Q / (A * A);
        d_hl_dA = hyd_dSf_dA(Q, K, dK) * Lres + K_q * 2.0 * V * dV_dA / (2.0 * G);
        const double dV_dQ = 1.0 / A;
        d_hl_dQ = hyd_dSf_dQ(Q, K) * Lres + K_q * 2.0 * V * dV_dQ / (2.0 * G);
    }
    const double target = (Y_new + sign * head_loss) - bed_level;
    const double area = curve ? interp_table(Y_new + sp[SP_BETA], area_stage, area_table, na) : SA;
    const double dY_dvol = Y_new <= min_stage ? 0.0 : 1.0 / area;
    const double res = h - target;
    *p_df_dh = 1.0 - sign * d_hl_dA * dA_dh;
    *p_df_dQ = -sign * (dY_dvol * 0.5 * dt + d_hl_dQ);
    *p_neg_res = -res;
    *p_stage = Y_new;
    return res;
}

// -- ops/boundary.py --------------------------------------------------------

struct Bc { double bed_level, bed_slope, init_depth; int kind; };

__device__ __forceinline__ void boundary_row(const Bc& bc, const Rating& rat, const Sec& s,
                                             double h, double Q, double target_k, double gate_open,
                                             double& res, double& df_dh, double& df_dQ) {
    switch (bc.kind) {
    case BC_FLOW:
        res = Q - target_k; df_dh = 0.0; df_dQ = 1.0; break;
    case BC_STAGE:
        res = h - (target_k - bc.bed_level); df_dh = 1.0; df_dQ = 0.0; break;
    case BC_FIXED:
        res = h - bc.init_depth; df_dh = 1.0; df_dQ = 0.0; break;
    case BC_NORMAL: {
        const double root = sqrt(fabs(bc.bed_slope));
        const double Qn = s.K * root;
        const double dQn = s.dK_dA * root;
        const bool neg = bc.bed_slope < 0.0;
        res = Q - (neg ? -Qn : Qn);
        df_dh = -(neg ? -dQn : dQn) * s.dA_dh;
        df_dQ = 1.0;
        break;
    }
    default: {  // BC_RATING
        const double stage = bc.bed_level + h;
        res = Q - rating_q(rat, stage, gate_open);
        df_dh = -rating_dq_dz(rat, stage, gate_open);
        df_dQ = 1.0;
        break;
    }
    }
}

// Sum over the block; every thread returns the same value (each adds the same
// per-warp partials in the same order), so a loop condition on it is uniform.
__device__ __forceinline__ double block_sum(double v, double* warp_part) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_part[warp] = v;
    __syncthreads();
    const int n_warps = (blockDim.x + 31) >> 5;
    double total = 0.0;
    for (int w = 0; w < n_warps; ++w) total += warp_part[w];
    return total;
}

// STORAGE selects the build with the lumped-storage rows: a run without
// storage takes the build that has no call to storage_row in it, so its
// register allocation is what it was before storage existed.
template <int BLOCK, bool STORAGE>
__global__ void __launch_bounds__(BLOCK)
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
                      int us_sflags, int ds_sflags, int us_nv, int us_na, int ds_nv, int ds_na) {
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

            double* src = buf0;
            double* dst = buf1;
            int stride = 1;
            for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                if (node) pcr::sweep_node<1>(src, dst, n, n, stride, i);
                __syncthreads();
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
#undef TDIFF
#undef SDIFF
#undef CAVG
#undef STORE_LEVEL
}

template <int BLOCK, bool STORAGE>
int launch(const double* geo, const double* h0, const double* Q0, const double* us,
           const double* ds, const double* par, const double* qlat, double* depth, double* flow,
           int* iters, double* err, int* conv, double* gate, double* stage, const double* stor,
           const double* stab, long long stab_stride, int n_sims, int n, int nt,
           int max_iter, int us_kind, int ds_kind, int rc_kind, int us_rc_kind,
           int store_boundaries, int qlat_mode, const int* st, cudaStream_t stream) {
    const int threads = ((n + 31) / 32) * 32;
    const size_t smem = (size_t)SMEM_DOUBLES_PER_NODE * n * sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(fused_simulate_kernel<BLOCK, STORAGE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    fused_simulate_kernel<BLOCK, STORAGE><<<n_sims, threads, smem, stream>>>(
        geo, h0, Q0, us, ds, par, qlat, depth, flow, iters, err, conv, gate, stage, stor, stab,
        stab_stride, n, nt, max_iter, pcr::n_sweeps(n), us_kind, ds_kind, rc_kind, us_rc_kind,
        store_boundaries, qlat_mode, st[0], st[1], st[2], st[3], st[4], st[5]);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flowsim_fused_param_count() { return P_COUNT; }
extern "C" int flowsim_fused_smem_bytes_per_node() { return SMEM_DOUBLES_PER_NODE * (int)sizeof(double); }
extern "C" int flowsim_fused_storage_param_count() { return SP_COUNT; }

// One block per simulation: n_sims = 1 is fused_simulate, n_sims = B is
// fused_simulate_batched.  Every array carries a leading n_sims axis (the
// storage tables only when stab_stride != 0).  st: the six storage ints
// {us flags, ds flags, us nv, us na, ds nv, ds na}; stage [n_sims, nt, 2] is
// filled with NaN by the caller.
extern "C" int flowsim_fused_simulate(const void* geo, const void* h0, const void* Q0,
                                      const void* us, const void* ds, const void* par,
                                      const void* qlat, void* depth, void* flow, void* iters,
                                      void* err, void* conv, void* gate, void* stage,
                                      const void* stor, const void* stab, long long stab_stride,
                                      int n_sims, int n,
                                      int nt, int max_iter, int us_kind, int ds_kind,
                                      int rc_kind, int us_rc_kind, int store_boundaries,
                                      int qlat_mode, const int* st, void* stream) {
    if (n_sims <= 0 || n <= 1 || n > 1024 || nt <= 0) return (int)cudaErrorInvalidValue;
    if (qlat_mode < QLAT_NONE || qlat_mode > QLAT_LEVELS) return (int)cudaErrorInvalidValue;
    if ((qlat_mode != QLAT_NONE) != (qlat != nullptr)) return (int)cudaErrorInvalidValue;
    if (st == nullptr || stage == nullptr) return (int)cudaErrorInvalidValue;
    if (((st[0] | st[1]) & ST_ON) && stor == nullptr) return (int)cudaErrorInvalidValue;
    if (((st[0] | st[1]) & ST_AREA_CURVE) && stab == nullptr) return (int)cudaErrorInvalidValue;
    const bool storage = (st[0] | st[1]) & ST_ON;
#define FLOWSIM_LAUNCH(B) (storage ? FLOWSIM_LAUNCH_AS(B, true) : FLOWSIM_LAUNCH_AS(B, false))
#define FLOWSIM_LAUNCH_AS(B, S) launch<B, S>((const double*)geo, (const double*)h0, (const double*)Q0, \
        (const double*)us, (const double*)ds, (const double*)par, (const double*)qlat, \
        (double*)depth, (double*)flow, (int*)iters, (double*)err, (int*)conv, (double*)gate, \
        (double*)stage, (const double*)stor, (const double*)stab, stab_stride, \
        n_sims, n, nt, max_iter, us_kind, ds_kind, rc_kind, us_rc_kind, store_boundaries, \
        qlat_mode, st, (cudaStream_t)stream)
    // the block size is a launch bound, so a small reach gets the full
    // register budget and only a long one is squeezed to 64 registers
    if (n <= 128) return FLOWSIM_LAUNCH(128);
    if (n <= 256) return FLOWSIM_LAUNCH(256);
    if (n <= 512) return FLOWSIM_LAUNCH(512);
    return FLOWSIM_LAUNCH(1024);
#undef FLOWSIM_LAUNCH
#undef FLOWSIM_LAUNCH_AS
}
